"""attn_roofline.prefill: K1's share of its roofline, in %, over every
launch of ``repro_torch::flash_attention_fwd`` in the traced batch (the
prefill's), as ``attn_roofline.train`` reckons it."""
from bench.metrics_common import roofline


def value(run):
    return roofline(run, ("repro_torch::flash_attention_fwd",))
