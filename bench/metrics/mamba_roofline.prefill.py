"""mamba_roofline.prefill: the Mamba mixers' share of their roofline in the
prefill, in %: the ``ssm.mamba`` spans inside ``serve.prefill`` of the
traced batch, each bound to one Mamba layer over the prefill's (rows,
tokens) by ``bench/work_hybrid.py`` (the largest of its matmuls at the bf16
peak, the rest at the fp32 peak, its bytes at HBM bandwidth), summed, over
the device time of the kernels launched inside both spans
(``bench/program_spans.py``'s rule)."""
from bench import work_hybrid
from bench.program_spans import launched_in


def value(run):
    tr = run.get("trace")
    if tr is None or "hybrid" not in run:
        return None
    mamba, prefill = launched_in(tr, ("ssm.mamba",)), launched_in(tr, ("serve.prefill",))
    if not mamba or not prefill:
        return None
    inside = {id(d) for d in prefill}
    busy_ns = sum(d.end - d.start for d in mamba if id(d) in inside)
    outer = [op for op in tr.ops.values() if op.name == "serve.prefill"]
    layers = sum(1 for op in tr.ops.values() if op.name == "ssm.mamba" and any(
        o.thread == op.thread and o.start <= op.start < o.end for o in outer))
    if not busy_ns or not layers:
        return None
    rows, tokens = run["prefill_shape"]
    return 100 * layers * work_hybrid.mamba_bound_s(run["hybrid"], rows, tokens) / (busy_ns / 1e9)
