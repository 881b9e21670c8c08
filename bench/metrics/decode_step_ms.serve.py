"""decode_step_ms.serve: the median host wall, in ms, of the window's
decode steps (each ended by its tokens' copy to the host). Host-paced: the
serve entry's dispatch sets it."""
import statistics


def value(run):
    steps = run.get("decode_step_s")
    return statistics.median(steps) * 1e3 if steps else None
