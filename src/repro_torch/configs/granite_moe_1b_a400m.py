"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab_size=49_155, head_dim=64,
    moe=MoEConfig(n_experts=32, top_k=8),
    activation="swiglu", norm="rmsnorm", pos="rope", tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="granite-moe-1b-a400m-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=4, capacity_factor=8.0),  # drop-free at test scale
    activation="swiglu", norm="rmsnorm", pos="rope", tie_embeddings=True,
)
