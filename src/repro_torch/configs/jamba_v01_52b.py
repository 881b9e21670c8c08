"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every other
layer. [arXiv:2403.19887; hf]
Period of 8: attention at offset 4, mamba elsewhere; MoE FFN on odd
offsets. Mamba state + 4 attention KV caches => sub-quadratic overall,
eligible for long_500k."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

_PERIOD = tuple("attn" if i == 4 else "mamba" for i in range(8))

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab_size=65_536, head_dim=128,
    block_pattern=_PERIOD * 4,
    moe=MoEConfig(n_experts=16, top_k=2, every_n_layers=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk_size=256),
    activation="swiglu", norm="rmsnorm", pos="none",
    sub_quadratic=True,
)

REDUCED = ArchConfig(
    name="jamba-v0.1-52b-reduced", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, head_dim=16,
    block_pattern=_PERIOD,
    moe=MoEConfig(n_experts=4, top_k=2, every_n_layers=2, capacity_factor=8.0),  # drop-free at test scale
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2, chunk_size=8),
    activation="swiglu", norm="rmsnorm", pos="none",
    sub_quadratic=True,
)
