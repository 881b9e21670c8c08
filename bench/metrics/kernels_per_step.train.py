"""kernels_per_step.train: device kernels launched in one train step, from
the traced slice."""


def value(run):
    tr = run.get("trace")
    if tr is None or not tr.kernels():
        return None
    return len(tr.kernels()) / tr.units
