"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab_size=151_936, head_dim=128, qk_norm=True,
    activation="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="qwen3-1.7b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, head_dim=16, qk_norm=True,
    activation="swiglu", norm="rmsnorm", pos="rope", tie_embeddings=True,
)
