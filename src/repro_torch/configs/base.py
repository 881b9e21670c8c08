"""Architecture configuration schema for the model zoo.

Every assigned architecture is a single frozen dataclass in its own module
under ``repro_torch.configs``; the registry maps ``--arch <id>`` to it. Reduced
variants (same family, tiny dims) back the CPU smoke tests; the full configs
are exercised only via the dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    every_n_layers: int = 1        # MoE FFN on layers where (l % every_n == every_n-1)
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2
    # "scatter" (default): one scatter-add dispatch + gather combine,
    # O(S*K*d) movement. "einsum": GShard dense one-hot (O(S*E*C*d) FLOPs),
    # kept as the reference baseline. Numerically identical routing.
    dispatch: str = "scatter"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model/16)
    # xlstm
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    chunk_size: int = 256          # chunked-parallel mLSTM


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # Attention / block features.
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    activation: str = "swiglu"     # swiglu | gelu
    pos: str = "rope"              # rope | learned | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Per-layer block types; empty => all "attn". Entries: attn | mamba |
    # mlstm | slstm. Length must equal n_layers when set.
    block_pattern: Tuple[str, ...] = ()

    # Modality frontend stub: None | "audio" | "vision". When set, inputs are
    # precomputed frame/patch embeddings of width d_model (assignment rule).
    frontend: Optional[str] = None

    max_seq_len: int = 32_768
    # Sub-quadratic decode state => eligible for the long_500k shape.
    sub_quadratic: bool = False

    # Training-time knobs.
    remat: str = "dots"            # none | dots | full
    scan_layers: bool = True
    use_flash: bool = False        # Pallas path (TPU); ref path on CPU

    def block_types(self) -> Tuple[str, ...]:
        if self.block_pattern:
            assert len(self.block_pattern) == self.n_layers
            return self.block_pattern
        return ("attn",) * self.n_layers

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe is None:
            return (False,) * self.n_layers
        k = self.moe.every_n_layers
        return tuple((l % k) == (k - 1) for l in range(self.n_layers))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        c = self
        total = c.vocab_size * c.d_model  # embed
        if not c.tie_embeddings:
            total += c.vocab_size * c.d_model  # lm head
        if c.pos == "learned":
            total += c.max_seq_len * c.d_model
        moe_mask = c.moe_layer_mask()
        for l, kind in enumerate(c.block_types()):
            if kind == "attn":
                total += c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
                if c.qkv_bias:
                    total += c.q_dim + 2 * c.kv_dim
                total += 2 * c.d_model  # norms
                total += self._ffn_params(moe_mask[l])
            elif kind == "mamba":
                s = c.ssm or SSMConfig()
                d_in = s.expand * c.d_model
                dt_rank = s.dt_rank or -(-c.d_model // 16)
                total += c.d_model * 2 * d_in            # in_proj
                total += d_in * s.d_conv                 # conv
                total += d_in * (dt_rank + 2 * s.d_state)  # x_proj
                total += dt_rank * d_in + d_in           # dt_proj
                total += d_in * s.d_state + d_in         # A_log, D
                total += d_in * c.d_model                # out_proj
                total += c.d_model                       # norm
                total += self._ffn_params(moe_mask[l])
            elif kind in ("mlstm", "slstm"):
                s = c.ssm or SSMConfig()
                pf = s.proj_factor_mlstm if kind == "mlstm" else 1.0
                d_in = int(pf * c.d_model)
                if kind == "mlstm":
                    total += c.d_model * 2 * d_in        # up (2 branches)
                    total += 3 * d_in * d_in // c.n_heads  # q,k,v per-head BlockLinear
                    total += c.d_model * 2 * c.n_heads   # i,f gate projections
                    total += d_in * c.d_model            # down
                else:
                    total += 4 * c.d_model * c.d_model   # i,f,z,o
                    total += 2 * int(c.d_model * s.proj_factor_slstm) * c.d_model
                total += 2 * c.d_model
        return total

    def _ffn_params(self, is_moe: bool) -> int:
        c = self
        if c.d_ff == 0:
            return 0
        n_mats = 3 if c.activation == "swiglu" else 2
        per_expert = n_mats * c.d_model * c.d_ff
        if is_moe and c.moe is not None:
            return c.moe.n_experts * per_expert + c.d_model * c.moe.n_experts
        return per_expert

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        c = self
        total = self.param_count()
        moe_layers = sum(self.moe_layer_mask())
        n_mats = 3 if c.activation == "swiglu" else 2
        per_expert = n_mats * c.d_model * c.d_ff
        total -= moe_layers * (c.moe.n_experts - c.moe.top_k) * per_expert
        return total
