"""attn_roofline.train: the attention kernels' share of their roofline, in
%: the sum of each launch's bound time over the sum of its device time,
over every K1, K2 and K3 launch of the traced slice (attributed by the
launching ``repro_torch::flash_attention_*`` op; the bound from the frozen
formulas of ``bench/work.py`` and the call's recorded shapes)."""
from bench.metrics_common import roofline


def value(run):
    return roofline(run, ("repro_torch::flash_attention_fwd", "repro_torch::flash_attention_dq",
                          "repro_torch::flash_attention_dkv"))
