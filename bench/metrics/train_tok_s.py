"""train_tok_s: tokens of every committed train step of the window, over
the window's seconds (from its start to its last step's end)."""


def value(run):
    steps = run.get("steps")
    if not steps:
        return None
    return sum(s["tokens"] for s in steps if s["committed"]) / run["window_s"]
