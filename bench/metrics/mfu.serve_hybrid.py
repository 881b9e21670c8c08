"""mfu.serve_hybrid: the window's hybrid model FLOPs per second over the
H100's bf16 peak, in %: 2 x the weights a token multiplies (a MoE layer's
router and the held experts a token meets on average) over each request's
prompt and fed tokens, the head over its served positions, attention, and
the Mamba layers' scan and conv (``bench/work_hybrid.py``)."""
from bench import work, work_hybrid


def value(run):
    reqs = run.get("requests")
    if not reqs or "hybrid" not in run:
        return None
    m = run["hybrid"]
    flops = sum(work_hybrid.serve_request_flops(m, r["prompt"], r["generated"]) for r in reqs)
    return 100 * flops / run["window_s"] / work.PEAK_FLOPS["bfloat16"]
