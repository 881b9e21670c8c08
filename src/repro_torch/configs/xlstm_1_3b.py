"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks at the paper's 7:1 ratio. [arXiv:2405.04517; unverified]
Blocks carry their own projections (mLSTM pf=2, sLSTM pf=4/3), hence
d_ff=0: no separate FFN sublayer. Recurrent state => sub-quadratic decode,
eligible for long_500k."""
from repro_torch.configs.base import ArchConfig, SSMConfig

_PATTERN = tuple(("mlstm",) * 7 + ("slstm",)) * 6  # 48 layers, 7:1

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50_304, head_dim=512,
    block_pattern=_PATTERN, ssm=SSMConfig(chunk_size=256),
    pos="none", norm="layernorm", sub_quadratic=True, tie_embeddings=True,
)

REDUCED = ArchConfig(
    name="xlstm-1.3b-reduced", family="ssm",
    n_layers=8, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0,
    vocab_size=128, head_dim=16,
    block_pattern=tuple(("mlstm",) * 7 + ("slstm",)),
    ssm=SSMConfig(chunk_size=8),
    pos="none", norm="layernorm", sub_quadratic=True, tie_embeddings=True,
)
