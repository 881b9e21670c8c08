"""optimizer_ms.train: device ms per train step of the kernels launched
inside the harness's ``bench.optimizer`` range (AdamW's update and the
consensus gate), from the traced slice."""


def value(run):
    tr = run.get("trace")
    if tr is None:
        return None
    got = tr.within("bench.optimizer")
    if not got:
        return None
    return sum(d.end - d.start for _, d in got) / 1e6 / tr.units
