"""serve_tok_s: generated tokens of every request served in the window,
over the window's seconds (from its start to its last batch's end)."""


def value(run):
    reqs = run.get("requests")
    if not reqs:
        return None
    return sum(r["generated"] for r in reqs) / run["window_s"]
