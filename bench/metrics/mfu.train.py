"""mfu.train: the window's model FLOPs per second over the H100's bf16
peak, in %: 6 x the weights a token multiplies x tokens plus attention's
forward and backward, for every committed step (``bench/work.py``; no
recompute, capacity slots or padding)."""
from bench import work


def value(run):
    steps = run.get("steps")
    if not steps:
        return None
    mix = run["traffic"]
    flops = work.train_step_flops(run["dims"], mix["batch"], mix["seq_len"])
    done = sum(1 for s in steps if s["committed"])
    return 100 * done * flops / run["window_s"] / work.PEAK_FLOPS["bfloat16"]
