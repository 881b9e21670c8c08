"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2. [arXiv:2404.16821; hf]
Backbone (InternLM2-1.8B-style LLM) only per the assignment: the InternViT
frontend is a STUB — input_specs() provides precomputed patch embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92_553, head_dim=128,
    activation="swiglu", norm="rmsnorm", pos="rope",
    frontend="vision",
)

REDUCED = ArchConfig(
    name="internvl2-2b-reduced", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=256, head_dim=16,
    activation="swiglu", norm="rmsnorm", pos="rope",
    frontend="vision",
)
