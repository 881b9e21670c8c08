"""The metric readers over a run's record: the idle share from the light
slice, and nothing from a trace that lost records."""
import pytest

from bench import spec, trace
from bench.metrics_common import idle_share


def test_idle_share_reads_the_light_slice():
    assert idle_share({}) is None
    assert idle_share({"busy": trace.Busy(busy_s=0.75, wall_s=1.0)}) == pytest.approx(25.0)


def test_busy_is_the_union_of_device_events():
    ev = [trace.Device("a", 0, 100, "kernel", 1), trace.Device("b", 50, 150, "kernel", 2),
          trace.Device("c", 300, 400, "gpu_memcpy", 3), trace.Device("d", 310, 320, "kernel", 4)]
    assert trace.busy_s(ev) == pytest.approx(250e-9)


@pytest.mark.parametrize("name", [x["name"] for x in spec.manifest()["per_layer"]
                                  if x["source"] == "device_trace"])
def test_no_reading_from_a_lost_trace(name):
    assert spec.reader(name)({"trace": None, "busy": None}) is None
