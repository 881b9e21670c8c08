"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048
— decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]
Backbone only per the assignment: the EnCodec frontend is a STUB —
input_specs() provides precomputed frame embeddings. LayerNorm + GELU +
learned positions, as in the HF release."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, head_dim=64,
    activation="gelu", norm="layernorm", pos="learned",
    frontend="audio", max_seq_len=32_768,
)

REDUCED = ArchConfig(
    name="musicgen-large-reduced", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
    vocab_size=128, head_dim=16,
    activation="gelu", norm="layernorm", pos="learned",
    frontend="audio", max_seq_len=512,
)
