"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA; head_dim=128 decoupled from d_model (q_dim
4096), as in the Qwen3 family. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab_size=151_936, head_dim=128, qk_norm=True,
    activation="swiglu", norm="rmsnorm", pos="rope", rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="qwen3-4b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=96,
    vocab_size=256, head_dim=16, qk_norm=True,
    activation="swiglu", norm="rmsnorm", pos="rope", tie_embeddings=True,
)
