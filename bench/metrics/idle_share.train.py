"""idle_share.train: the share of the light slice's wall in which no
device operation ran, in % (the profiler records the device alone there)."""
from bench.metrics_common import idle_share


def value(run):
    return idle_share(run)
