"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Note: routed experts only (16e top-1) per the assignment line; the shared
expert of the HF release is not modeled (recorded in DESIGN.md)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202_048, head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=1),
    activation="swiglu", norm="rmsnorm", pos="rope", rope_theta=500_000.0,
)

REDUCED = ArchConfig(
    name="llama4-scout-17b-a16e-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, head_dim=16,
    moe=MoEConfig(n_experts=4, top_k=1, capacity_factor=8.0),  # drop-free at test scale
    activation="swiglu", norm="rmsnorm", pos="rope",
)
