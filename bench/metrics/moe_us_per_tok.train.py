"""moe_us_per_tok.train: device microseconds per token of the kernels
launched inside the MoE layer's four stage ranges (``bench.moe.gates``,
``.slots``, ``.dispatch``, ``.combine``; the forward and the rematerialised
forward, not the backward's own kernels), from the traced slice."""


def value(run):
    tr = run.get("trace")
    if tr is None:
        return None
    got = tr.within("bench.moe.")
    if not got:
        return None
    return sum(d.end - d.start for _, d in got) / 1e3 / tr.tokens
