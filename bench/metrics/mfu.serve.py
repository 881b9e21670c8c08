"""mfu.serve: the window's model FLOPs per second over the H100's bf16
peak, in %: 2 x weights over each request's unpadded prompt and fed
tokens, the head over its served positions, and attention
(``bench/work.py``)."""
from bench import work


def value(run):
    reqs = run.get("requests")
    if not reqs:
        return None
    m = run["dims"]
    flops = sum(work.serve_request_flops(m, r["prompt"], r["generated"]) for r in reqs)
    return 100 * flops / run["window_s"] / work.PEAK_FLOPS["bfloat16"]
