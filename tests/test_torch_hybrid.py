"""Jamba's hybrid block in the port, as AI21-Jamba2-Mini runs it: Mamba-1
with its inner norms on dt, B and C, GQA attention without rotation,
dropless top-2 MoE whose gates are not renormalised, and one card's share
of the experts. Held on the CPU, in float32 at a reduced size of the same
pattern (8 layers, one period: attention at offset 4, MoE on odd layers),
against the benchmark's plain reference (``bench/reference/hybrid.py``),
with weights from ``bench/hybrid.py``'s seeded draw.

Tolerances: program and reference both compute in float32 and differ in
the order of their sums only (the program's doubling scan against a
sequential one, K1's plain path against a softmax over full scores, a
grouped product against one product an expert), so logits of order 1 agree
to ~1e-6; 2e-5 leaves room for that order and no room for a missing term
(leaving out the inner norms moves the mixer's output, renormalising the
gates the MoE's, by more than 1e-2: ``test_inner_norms_and_gate_matter``)."""
import copy
import dataclasses

import pytest
import torch

from bench import hybrid
from bench.reference import hybrid as ref
from repro_torch import tracing
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import zoo
from repro_torch.runtime.serve import build_serve_fns

SMALL = {
    "name": "ai21-jamba2-mini-small", "hidden_act": "silu", "num_hidden_layers": 8,
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 96, "vocab_size": 256, "tie_word_embeddings": False,
    "rms_norm_eps": 1e-6, "attn_layer_period": 8, "attn_layer_offset": 4,
    "expert_layer_period": 2, "expert_layer_offset": 1, "num_experts": 4,
    "num_experts_per_tok": 2, "mamba_d_state": 8, "mamba_d_conv": 4, "mamba_expand": 2,
    "mamba_dt_rank": 8, "mamba_conv_bias": True, "mamba_proj_bias": False,
    "max_position_embeddings": 128, "torch_dtype": "float32",
    "published": {"num_experts": 8}, "port": {"held_first": 2, "chunk_size": 8},
}
TOL = dict(atol=2e-5, rtol=2e-5)
CPU = torch.device("cpu")


def config(**port):
    c = copy.deepcopy(SMALL)
    c["port"].update(port)
    return c


def scrambled(tree, seed=3):
    """The tree with every norm scale drawn around 1, so that a scale left
    out shows."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = scrambled(v, seed + 1)
        elif k in ("scale", "dt_norm", "b_norm", "c_norm"):
            out[k] = 1 + 0.3 * torch.randn(v.shape, generator=gen)
        else:
            out[k] = v
    return out


def test_layout_is_the_programs_tree():
    c = config()
    model = zoo.build(hybrid.arch_config(c), dtype=torch.float32, device="cpu")
    hybrid.check_layout(hybrid.dims(c), model.param_shapes(), torch.float32)
    with pytest.raises(RuntimeError, match="not the benchmark's layout"):
        hybrid.check_layout(hybrid.dims(config(inner_norms=False)), model.param_shapes(),
                            torch.float32)


@pytest.mark.parametrize("seed", [2**31 + 5, 17])
def test_prefill_then_decode_match_reference(seed):
    """The serve path's prefill logits, then three cached decode steps, each
    against the reference's full forward over the same tokens."""
    c = config()
    m = hybrid.dims(c)
    weights = scrambled(hybrid.make_weights(m, seed, CPU, torch.float32))
    model = zoo.build(hybrid.arch_config(c), dtype=torch.float32, device="cpu")
    params = model.load(weights)
    prefill_fn, decode_fn = build_serve_fns(model, 32, "cpu")
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, m.vocab, (2, 24), generator=gen)
    fed = torch.randint(1, m.vocab, (2, 3), generator=gen)
    logits, cache = prefill_fn(params, {"tokens": tokens})
    got = [logits]
    for t in range(3):
        logits, cache = decode_fn(params, cache, {"tokens": fed[:, t:t + 1]})
        got.append(logits)
    got = torch.stack(got, dim=1)                                          # (2, 4, V)
    seqs = list(torch.cat([tokens, fed], dim=1))
    want = ref.served_logits(m, weights, seqs, [(23, 27)] * 2, "fp32")
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], **TOL)


def _mamba_case(seed=1, T=16):
    c = config()
    m, cfg = hybrid.dims(c), hybrid.arch_config(c)
    p = scrambled(hybrid.layer_params(hybrid.make_weights(m, seed, CPU, torch.float32), m, 0))
    x = torch.randn(2, T, m.d, generator=torch.Generator().manual_seed(seed))
    return m, cfg, p["mixer"], x


def test_mamba_inner_norms_match_reference():
    """Mamba alone, its inner norms' scales drawn around 1: the uncached
    forward, and the same tokens as a prefill of 8 then 8 one-token steps
    with the carried state."""
    m, cfg, p, x = _mamba_case()
    want = ref.mamba(m, p, x, "fp32")
    y, _ = S.apply_mamba(cfg, p, x)
    torch.testing.assert_close(y, want, **TOL)
    state = S.init_mamba_state(cfg, 2, "cpu", torch.float32)
    y0, state = S.apply_mamba(cfg, p, x[:, :8], state=state)
    steps = [y0]
    for t in range(8, 16):
        yt, state = S.step_mamba(cfg, p, x[:, t:t + 1], state)
        steps.append(yt)
    torch.testing.assert_close(torch.cat(steps, dim=1), want, **TOL)


def test_gate_not_renormalised_matches_reference():
    m, cfg, _, _ = _mamba_case()
    p = hybrid.layer_params(hybrid.make_weights(m, 4, CPU, torch.float32), m, 1)["ffn"]
    x = torch.randn(1, 40, m.d, generator=torch.Generator().manual_seed(4))
    y, _ = M.apply_moe(cfg, p, x, with_aux=False)
    torch.testing.assert_close(y[0], ref.moe(m, p, x[0], "fp32"), **TOL)


def test_inner_norms_and_gate_matter():
    """What the tolerance has to catch: the program without the inner norms,
    or with its gates renormalised, is far off the reference."""
    m, cfg, p, x = _mamba_case()
    want = ref.mamba(m, p, x, "fp32")
    off = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, inner_norms=False))
    assert (S.apply_mamba(off, p, x)[0] - want).abs().max() > 1e-2
    f = hybrid.layer_params(hybrid.make_weights(m, 4, CPU, torch.float32), m, 1)["ffn"]
    xt = torch.randn(1, 40, m.d, generator=torch.Generator().manual_seed(4))
    norm = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, norm_topk=True))
    assert (M.apply_moe(norm, f, xt, with_aux=False)[0][0]
            - ref.moe(m, f, xt[0], "fp32")).abs().max() > 1e-2


def test_dropless_matches_reference_at_skewed_routing():
    """A router that sends nearly every token's first choice to one held
    expert: the capacity path would drop most of them (its count says so),
    the dropless one drops none and matches the reference."""
    m, cfg, _, _ = _mamba_case()
    p = dict(hybrid.layer_params(hybrid.make_weights(m, 6, CPU, torch.float32), m, 1)["ffn"])
    gen = torch.Generator().manual_seed(6)
    u = torch.randn(m.d, generator=gen)
    u = u / u.norm()
    router = p["router"].clone()
    router[:, m.held_first + 1] += 2 * u   # held expert 1 of this card's 4
    p["router"] = router
    x = torch.randn(2, 32, m.d, generator=gen) + 4 * u   # every token leans along u
    top = torch.topk(torch.softmax(x.reshape(-1, m.d) @ router, -1), 2, -1).indices
    assert (top[:, 0] == m.held_first + 1).float().mean() > 0.9
    tracing.enable()
    try:
        y, _ = M.apply_moe(cfg, p, x, with_aux=False)
        capped = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
        M.apply_moe(capped, p, x, with_aux=False)
    finally:
        tracing.disable()
    counts = tracing.drain().counts
    held = ((top >= m.held_first) & (top < m.held_first + m.held)).sum()
    assert counts["moe.held"] == 2 * int(held) and counts["moe.choices"] == 2 * top.numel()
    assert counts["moe.dropped"] > top.numel() // 4
    torch.testing.assert_close(y.reshape(-1, m.d), ref.moe(m, p, x.reshape(-1, m.d), "fp32"),
                               **TOL)


def test_expert_shares_sum_to_the_uncut_layer():
    """Two cards' shares, experts (0, 2) and (2, 2) of 4, each the held
    experts' part of the result; their sum is the uncut layer's result (no
    shared expert: nothing every card computes alike)."""
    c = config()
    c["published"]["num_experts"] = 4
    c["num_experts"], c["port"]["held_first"] = 4, 0
    m, cfg = hybrid.dims(c), hybrid.arch_config(c)
    p = hybrid.layer_params(hybrid.make_weights(m, 8, CPU, torch.float32), m, 1)["ffn"]
    x = torch.randn(2, 24, m.d, generator=torch.Generator().manual_seed(8))
    whole, _ = M.apply_moe(cfg, p, x, with_aux=False)
    parts = []
    for first in (0, 2):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, held=(first, 2)))
        sp = {k: v[first:first + 2] if k.endswith("_e") else v for k, v in p.items()}
        parts.append(M.apply_moe(share, sp, x, with_aux=False)[0])
    torch.testing.assert_close(parts[0] + parts[1], whole, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(whole[0], ref.moe(m, p, x[0], "fp32"), **TOL)
    assert min(float(q.abs().max()) for q in parts) > 1e-2  # each share adds something


def test_dropless_bf16_grouped_product():
    """bf16, the card's type: the grouped product (``torch._grouped_mm``)
    with undefined rows past the held experts masked out, against the
    float32 one-product-an-expert path: within bf16's rounding of a few
    products (2^-8 relative, ~0.03 here)."""
    m, cfg, _, _ = _mamba_case()
    p = hybrid.layer_params(hybrid.make_weights(m, 9, CPU, torch.float32), m, 1)["ffn"]
    x = torch.randn(3, 16, m.d, generator=torch.Generator().manual_seed(9))
    want, _ = M.apply_moe(cfg, p, x, with_aux=False)
    pb = {k: v if k == "router" else v.bfloat16() for k, v in p.items()}
    got, _ = M.apply_moe(cfg, pb, x.bfloat16(), with_aux=False)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=3e-2)


def test_spans_and_counters_of_the_hybrid_serve():
    """``moe.sort`` and ``ssm.scan`` open in a served batch, ``moe.held``
    counts the first forward's pairs of held experts, and
    ``ssm.scan_tokens`` every fed token of every row in every Mamba layer."""
    c = config()
    m = hybrid.dims(c)
    model = zoo.build(hybrid.arch_config(c), dtype=torch.float32, device="cpu")
    params = model.load(hybrid.make_weights(m, 12, CPU, torch.float32))
    prefill_fn, decode_fn = build_serve_fns(model, 24, "cpu")
    tokens = torch.randint(1, m.vocab, (2, 16), generator=torch.Generator().manual_seed(12))
    tracing.enable()
    try:
        logits, cache = prefill_fn(params, {"tokens": tokens})
        decode_fn(params, cache, {"tokens": logits.argmax(-1)[:, None]})
    finally:
        tracing.disable()
    got = tracing.drain()
    names = {s.name for s in got.spans}
    assert {"moe.gates", "moe.sort", "moe.experts", "moe.combine", "ssm.mamba",
            "ssm.scan"} <= names
    assert not names & {"moe.slots", "moe.dispatch"}
    layers = sum(hybrid.dims(c).is_moe(i) for i in range(m.layers))
    assert got.counts["moe.choices"] == layers * (2 * 16 + 2) * m.top_k
    assert 0 < got.counts["moe.held"] < got.counts["moe.choices"]
    mamba = sum(m.kind(i) == "mamba" for i in range(m.layers))
    assert mamba == 7 and got.counts["ssm.scan_tokens"] == mamba * 2 * (16 + 1)
