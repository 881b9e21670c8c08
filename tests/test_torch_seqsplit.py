"""Serving a batch that does not split over the data-parallel ranks, on the
CPU: ``sharding.serve_plan`` against ``repro``'s ``batch_spec`` /
``cache_spec``; the plain log-sum-exp variant of decode attention on slices
of a cache, merged by ``merge_partials``, against ``repro.kernels.ref``; K4's
wrapper for the variant (its C library replaced by a recorder); and serving
on gloo ranks against ``repro``'s one-device ``Model.prefill`` /
``decode_step`` on the same parameters (initialised in JAX,
``convert.params_from_numpy``), at logits rtol/atol 2e-4
(tests/test_models_smoke.py):

  2 ranks (data=2, model=1), cache of 16 in slices of 8: reduced
      qwen3-1.7b at batch 1 and 3, reduced jamba-v0.1-52b and xlstm-1.3b at
      batch 3 (their recurrent states whole on every rank)
  4 ranks (data=2, model=2): qwen at batch 1 and 3, and the head-dim split
      of tests/test_torch_tp_headdim.py (12 query and 3 KV heads of 8: each
      rank caches every KV head's half of the dims, pads its 6 query heads
      to 8) at batch 3
  4 ranks (pod=2, data=2, model=1): batch 2, rows over "data" only
  4 ranks (data=4, model=1): batch 1 over a cache of 16 (slices of 4), and
      batch 3 over a cache of 30, which does not divide "data": whole

Prompts of 8 tokens and 4 decode steps: the ranks past position 8 start
empty, and decode crosses into the next slice. Then, for the cases of
``LATER``, cached steps that the serve path does not take, held to
``repro``'s one-device ``decode_step`` on the same steps and to one rank's
whole cache (the port with no mesh) at the same tolerance: 3-token steps at
positions 8 and 11 (across slices), and per-row positions (a (B,) tensor of
the global batch: 7, 3, 5) for a 1-token and a 3-token step.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_tp_ssm import _flat, _nested  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT, DECODES = 8, 4
ARCHS = {
    "qwen": ("qwen3-1.7b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "xlstm": ("xlstm-1.3b", {}),
    "phi3_12_3": ("phi3-medium-14b", {"n_heads": 12, "n_kv_heads": 3, "head_dim": 8}),
}
MESHES = {
    "d2": ((2, 1), ("data", "model")),
    "d2m2": ((2, 2), ("data", "model")),
    "p2d2": ((2, 2, 1), ("pod", "data", "model")),
    "d4": ((4, 1), ("data", "model")),
}
# name -> (arch, batch, cache length, mesh)
CASES = {
    "qwen_b1_d2": ("qwen", 1, 16, "d2"),
    "qwen_b3_d2": ("qwen", 3, 16, "d2"),
    "jamba_b3_d2": ("jamba", 3, 16, "d2"),
    "xlstm_b3_d2": ("xlstm", 3, 16, "d2"),
    "qwen_b1_d2m2": ("qwen", 1, 16, "d2m2"),
    "qwen_b3_d2m2": ("qwen", 3, 16, "d2m2"),
    "headdim_b3_d2m2": ("phi3_12_3", 3, 16, "d2m2"),
    "qwen_b2_p2d2": ("qwen", 2, 16, "p2d2"),
    "qwen_b1_d4": ("qwen", 1, 16, "d4"),
    "qwen_b3_s30_d4": ("qwen", 3, 30, "d4"),
}
# The cases that also run ``_later_steps``: the split over 2 and 4 slices,
# with the KV heads or their head dim over "model", a whole cache, and rows
# split over "data" (each rank runs its rows of the (B,) position).
LATER = ("qwen_b3_d2", "qwen_b3_d2m2", "headdim_b3_d2m2", "qwen_b1_d4", "qwen_b3_s30_d4",
         "qwen_b2_p2d2")
ROW_POS = (7, 3, 5)
WORLDS = {2: [c for c in CASES if CASES[c][3] == "d2"],
          4: [c for c in CASES if CASES[c][3] != "d2"]}


def _cfg(registry, arch):
    name, changes = ARCHS[arch]
    return dataclasses.replace(registry.get(name, reduced=True), **changes)


def _tokens(vocab, B):
    return np.random.RandomState(11).randint(0, vocab, (B, PROMPT + DECODES))


# ------------------------------------------------------------ (i) the plan


PLAN_MESHES = {"(2,1)": ((2, 1), ("data", "model")), "(4,1)": ((4, 1), ("data", "model")),
               "(2,2)": ((2, 2), ("data", "model")),
               "(pod2,2,1)": ((2, 2, 1), ("pod", "data", "model"))}


@pytest.mark.parametrize("B", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("mesh_name", list(PLAN_MESHES))
def test_plan_equals_repro_specs(mesh_name, B):
    """The plan's row axes are repro's batch_spec of the tokens, its
    sequence axis the S entry of repro's cache_spec of an attention cache
    (stacked (G, B, S, Hkv, Dh)), for caches of 30 and 64 positions; the B
    entry of cache_spec is the row axes too, and a Mamba state's spec never
    names "data" past its B entry (the state stays whole in S)."""
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.runtime import sharding as jshd
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.runtime import sharding as shd

    sizes, names = PLAN_MESHES[mesh_name]
    mesh, jmesh = AbstractMesh.of(sizes, names), JAbstractMesh(sizes, names)

    def axes(entry):
        return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))

    for S in (30, 64):
        plan = shd.serve_plan(B, S, mesh)
        assert plan.rows is None and plan.seq is None  # no ranks behind an AbstractMesh
        assert plan.row_axes == axes(jshd.batch_spec("tokens", (B, 8), jmesh)[0])
        kv = tuple(jshd.cache_spec("layers/b0/k", (2, B, S, 4, 16), jmesh))
        assert plan.row_axes == axes(kv[1]), (S, kv)
        assert plan.seq_axis == kv[2], (S, kv)
        h = tuple(jshd.cache_spec("layers/b0/h", (2, B, 32, 4), jmesh))
        assert h[1] == kv[1] and "data" not in axes(h[2]) + axes(h[3])
        # What the plan gives this case: rows over pod x data, over data
        # alone, or every row on every rank and S split where it divides.
        n_dp = sizes[0] * (sizes[1] if names[0] == "pod" else 1)
        n_data = sizes[names.index("data")]
        if B % n_dp == 0:
            assert plan.row_axes == tuple(a for a in ("pod", "data") if a in names)
        elif B % n_data == 0:
            assert plan.row_axes == ("data",)
        else:
            assert plan.row_axes == () and plan.seq_axis == ("data" if S % n_data == 0
                                                                 else None)


class _StubMesh:
    """A mesh of ranks as ``serve_plan`` reads it, at coordinates given by
    hand: each axis's group is its name, the data-parallel group "batch"."""

    def __init__(self, sizes, names, coords):
        self.shape, self.axis_names, self.coords = dict(zip(names, sizes)), tuple(names), coords

    def group(self, name):
        return name

    def axis_index(self, name):
        return self.coords[name]

    def batch_group(self):
        return "batch"

    def batch_index(self):
        return self.coords.get("pod", 0) * self.shape.get("data", 1) + self.coords.get("data", 0)


@pytest.mark.parametrize("sizes,names,B,S,rows,seq", [
    ((2, 2, 1), ("pod", "data", "model"), 4, 64, (3, 4, "batch"), None),  # case 1
    ((2, 2, 1), ("pod", "data", "model"), 2, 64, (1, 2, "data"), None),   # case 2
    ((2, 2, 1), ("pod", "data", "model"), 3, 64, None, (1, 2, 32)),       # case 3
    ((4, 1), ("data", "model"), 3, 30, None, None),                      # S stays whole
    ((2,), ("pod",), 2, 64, (1, 2, "batch"), None),                      # no "data" axis
    ((2,), ("model",), 3, 64, None, None),                               # no batch axis
])
def test_plan_on_a_mesh_of_ranks(sizes, names, B, S, rows, seq):
    """On a mesh of ranks the plan also names this rank's row split (its
    index, the split's size and group) and its sequence split (index, size,
    positions a rank); the rank sits at coordinate 1 of every axis."""
    from repro_torch.runtime import sharding as shd

    mesh = _StubMesh(sizes, names, {n: 1 for n in names})
    plan = shd.serve_plan(B, S, mesh)
    assert plan.rows == rows
    got = None if plan.seq is None else (plan.seq.index, plan.seq.size, plan.seq.length)
    assert got == seq and (plan.seq is None or plan.seq.group == "data")


def test_cache_shapes_follow_the_plan():
    """Reduced jamba-v0.1-52b at batch 3 on (data=2, model=2) over 64
    positions: each attention cache leaf's local shape is repro's
    cache_spec applied to repro's shape (S halved, KV heads split over
    "model"); the Mamba states keep every row."""
    import math

    from jax.sharding import AbstractMesh as JAbstractMesh
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo
    from repro.runtime import sharding as jshd
    from repro_torch.configs import registry
    from repro_torch.core.collective import ModelParallel, SeqSplit
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import zoo
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import leaves_with_paths

    sizes, names = (2, 2), ("data", "model")
    mesh, jmesh = AbstractMesh.of(sizes, names), JAbstractMesh(sizes, names)
    B, S = 3, 64
    plan = shd.serve_plan(B, S, mesh)
    assert plan.row_axes == () and plan.seq_axis == "data"
    jcache = jax.eval_shape(lambda: jzoo.build(jregistry.get("jamba-v0.1-52b", reduced=True))
                            .init_cache(B, S))["layers"]
    jspecs = {jshd.path_str(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        jshd.tree_cache_specs({"layers": jcache}, jmesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    jshapes = {jshd.path_str(p): s.shape
               for p, s in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    model = zoo.build(registry.get("jamba-v0.1-52b", reduced=True), device="cpu")
    with FakeTensorMode():
        cache = model.init_cache(B, S, tp=ModelParallel(None, 0, 2), seq=SeqSplit(None, 0, 2, 32))
    seen = set()
    for path, leaf in leaves_with_paths(cache["layers"]):
        key = "/".join(path)
        spec = jspecs["layers/" + key]
        want = tuple(n // math.prod(mesh.shape[a] for a in ((e,) if isinstance(e, str) else e))
                     if e else n for n, e in zip(jshapes[key], spec))
        assert tuple(leaf.shape) == want, (key, tuple(leaf.shape), want)
        seen.add(path[-1])
    assert {"k", "v", "h", "conv"} <= seen


# ------------------------------------------- (ii) the partials and their merge


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kv_len", [[40, 64, 1], [17, 5, 33]])
def test_merged_slices_equal_whole_cache_decode(n, kv_len):
    """decode_attention(lse=True) of each of n slices of a 64-position cache
    (a row's local kv_len clamped to its slice, so some slices hold no key
    of a row), merged by merge_partials, equals repro's
    ref.decode_attention over the whole cache at f32 2e-5."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import merge_partials

    B, S, Hq, Hkv, D = 3, 64, 8, 2, 16
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    L = S // n
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    os_, lses = [], []
    for r in range(n):
        local = torch.tensor([min(max(kl - r * L, 0), L) for kl in kv_len])
        o, lse = ops.decode_attention(tq, tk[:, r * L:(r + 1) * L].contiguous(),
                                      tv[:, r * L:(r + 1) * L].contiguous(), local, lse=True)
        assert o.dtype == lse.dtype == torch.float32
        assert o.shape == (B, Hq, D) and lse.shape == (B, Hq)
        os_.append(o)
        lses.append(lse)
    assert any(min(max(kl - (n - 1) * L, 0), L) == 0 for kl in kv_len)  # an empty slice
    got = merge_partials(torch.stack(os_), torch.stack(lses), torch.float32)
    want = jref.decode_attention(jax.numpy.asarray(q), jax.numpy.asarray(k),
                                 jax.numpy.asarray(v), jax.numpy.asarray(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-2)


def test_lse_variant_is_the_logsumexp_and_empty_rows_are_zero():
    """The plain variant's lse is torch.logsumexp of the scaled scores
    below kv_len; its o equals the o-only call's; a row with kv_len 0 gives
    o = 0 and lse = NEG_INF exactly (the o-only call averages V there,
    ROADMAP C), and such a partial weighs nothing in the merge."""
    import math

    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(*s, generator=gen) for s in ((2, 4, 16), (2, 20, 2, 16),
                                                        (2, 20, 2, 16)))
    kv_len = torch.tensor([13, 0])
    o, lse = ref.decode_attention(q, k, v, kv_len, lse=True)
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(2, 2, 2, 16) / math.sqrt(16), k)[0, ..., :13]
    torch.testing.assert_close(lse[0], torch.logsumexp(s, -1).reshape(4), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(o[0], ref.decode_attention(q, k, v, kv_len)[0], rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert torch.equal(lse[1], torch.full_like(lse[1], ref.NEG_INF))
    merged = ref.merge_partials(torch.stack([o, torch.zeros_like(o)]),
                                torch.stack([lse, torch.full_like(lse, ref.NEG_INF)]),
                                torch.bfloat16)
    assert merged.dtype == torch.bfloat16
    torch.testing.assert_close(merged.float(), o.bfloat16().float())


class _FakeDecodeLib:
    """Records the arguments of each C call of K4's library."""

    def __init__(self):
        self.calls = []

    def decode_attention(self, *args):
        self.calls.append(("decode_attention", args))
        return 0

    def decode_attention_lse(self, *args):
        self.calls.append(("decode_attention_lse", args))
        return 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_variant_reaches_its_own_entry_point(dtype, monkeypatch):
    """K4's wrapper with lse=True: one call of decode_attention_lse with an
    fp32 o and an fp32 (B, Hq) lse after it, whatever q's type, counted as
    "decode_attention_lse"; the o-only call still reaches decode_attention
    with o in q's type. Both share the stream's workspace."""
    from repro_torch.kernels import decode_attention as dec

    lib = _FakeDecodeLib()
    monkeypatch.setattr(dec, "_lib", lambda: lib)
    monkeypatch.setattr(dec, "check_cuda", lambda *a: None)
    monkeypatch.setattr(dec, "raw_stream", lambda t: 0)
    monkeypatch.setattr(dec, "launches", dec.collections.Counter())
    monkeypatch.setattr(dec, "_scratch", {})
    q, k = torch.zeros(2, 4, 16, dtype=dtype), torch.zeros(2, 300, 2, 16, dtype=dtype)
    o, lse = dec.decode_attention(q, k, k, 0, lse=True)
    assert o.dtype == lse.dtype == torch.float32 and o.shape == (2, 4, 16) and lse.shape == (2, 4)
    o2 = dec.decode_attention(q, k, k, 40)
    assert o2.dtype == dtype
    (name, args), (name2, args2) = lib.calls
    assert name == "decode_attention_lse" and name2 == "decode_attention"
    assert args[3] is None and args[4] == 0  # kv_len 0 as a scalar
    assert args[7:9] == (o.data_ptr(), lse.data_ptr()) and args2[7] == o2.data_ptr()
    assert args[5:7] == args2[5:7]  # one workspace and counters
    assert args[9:] == args2[8:] and args[9:16] == (2, 300, 4, 2, 16, dec.n_splits(300),
                                                    dec.BLK_S)
    assert dec.launches == {"decode_attention_lse": 1, "decode_attention": 1}


# ------------------------------------------------------ (iii)-(v) the ranks


def _jax_side():
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo

    init, ref, later, models = {}, {}, {}, {}
    for arch in ARCHS:
        model = jzoo.build(_cfg(jregistry, arch), dtype=jnp.float32)
        params = model.init(jax.random.PRNGKey(0))
        init.update(_flat(params, f"{arch}/"))
        models[arch] = (model, params)
    runs = {}  # (arch, B, S) -> logits: cases on different meshes share them
    for case, (arch, B, S, _) in CASES.items():
        if (arch, B, S) not in runs:
            model, params = models[arch]
            tokens = jnp.asarray(_tokens(model.cfg.vocab_size, B))
            out, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]}, S)
            steps = [out]
            for i in range(DECODES):
                out, cache = model.decode_step(params, cache,
                                               {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]})
                steps.append(out)
            runs[arch, B, S] = np.stack([np.asarray(s) for s in steps])
        ref[case] = runs[arch, B, S]
        if case in LATER:
            if (arch, B, S, "later") not in runs:
                model, params = models[arch]
                runs[arch, B, S, "later"] = _jax_later_steps(
                    model, params, jnp.asarray(_tokens(model.cfg.vocab_size, B)), S)
            later[case] = runs[arch, B, S, "later"]
    return init, ref, later


def _jax_later_steps(model, params, tokens, S):
    """``_later_steps`` through ``repro``'s one-device ``prefill`` and
    ``decode_step``, its position a (B,) int32 array for the rows."""
    import jax.numpy as jnp

    B = tokens.shape[0]
    out = {"multi": [], "rows": []}
    _, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]}, S)
    for step in (tokens[:, PROMPT:PROMPT + 3], tokens[:, 1:4]):
        logits, cache = model.decode_step(params, cache, {"tokens": step})
        out["multi"].append(np.asarray(logits))
    _, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]}, S)
    cache = {**cache, "pos": jnp.asarray(ROW_POS[:B], jnp.int32)}
    for step in (tokens[:, PROMPT:PROMPT + 1], tokens[:, PROMPT + 1:PROMPT + 4]):
        logits, cache = model.decode_step(params, cache, {"tokens": step})
        out["rows"].append(np.asarray(logits))
    return out


def _later_steps(fns, params, tokens):
    """Logits of cached steps past the prompt: (multi) 3-token steps at
    positions 8 and 11; (rows) from a fresh prefill, the cache's position
    set to one per row (``ROW_POS``, a tensor), a 1-token then a 3-token
    step."""
    prefill_fn, decode_fn = fns
    B = tokens.shape[0]
    out = {"multi": [], "rows": []}
    _, cache = prefill_fn(params, {"tokens": tokens[:, :PROMPT]})
    for step in (tokens[:, PROMPT:PROMPT + 3], tokens[:, 1:4]):
        logits, cache = decode_fn(params, cache, {"tokens": step})
        out["multi"].append(logits)
    _, cache = prefill_fn(params, {"tokens": tokens[:, :PROMPT]})
    cache["pos"] = torch.tensor(ROW_POS[:B])
    for step in (tokens[:, PROMPT:PROMPT + 1], tokens[:, PROMPT + 1:PROMPT + 4]):
        logits, cache = decode_fn(params, cache, {"tokens": step})
        out["rows"].append(logits)
    out["pos"] = cache["pos"]
    return out


def _rank_main(rank, world, init_file, init_path, out_dir):
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import collective as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import zoo
    from repro_torch.launch.hlo_analysis import Collectives
    from repro_torch.runtime.serve import build_serve_fns, shard_params
    from torch_fake_group import summary

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        init = dict(np.load(init_path))
        meshes, out = {}, {}
        for case in WORLDS[world]:
            arch, B, S, mesh_name = CASES[case]
            if mesh_name not in meshes:
                meshes[mesh_name] = make_mesh(*MESHES[mesh_name], device_type="cpu")
            mesh = meshes[mesh_name]
            cfg = _cfg(registry, arch)
            model = zoo.build(cfg, dtype=torch.float32, device="cpu")
            local = shard_params(model, params_from_numpy(_nested(init, arch), "cpu"), mesh)
            tokens = torch.from_numpy(_tokens(cfg.vocab_size, B)).long()
            prefill_fn, decode_fn = build_serve_fns(model, S, "cpu", mesh)
            C.reset_tp_counts()
            with Collectives() as counted:
                logits, cache = prefill_fn(local, {"tokens": tokens[:, :PROMPT]})
            counts, collectives = [C.tp_counts()], [summary(counted)]
            steps = [logits]
            for i in range(DECODES):
                C.reset_tp_counts()
                with Collectives() as counted:
                    logits, cache = decode_fn(local, cache,
                                              {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]})
                counts.append(C.tp_counts())
                collectives.append(summary(counted))
                steps.append(logits)
            out[case] = {"logits": torch.stack(steps), "counts": counts,
                         "collectives": collectives,
                         "cache": {k: tuple(v.shape) for k, v in cache["layers"]["b0"].items()},
                         "coords": {a: mesh.axis_index(a) for a in mesh.axis_names}}
            if case in LATER:  # (v): later steps here and on one rank's whole cache
                one = zoo.build(cfg, dtype=torch.float32, device="cpu")
                whole = one.load(params_from_numpy(_nested(init, arch), "cpu"))
                out[case]["later"] = _later_steps((prefill_fn, decode_fn), local, tokens)
                out[case]["later_one"] = _later_steps(build_serve_fns(one, S, "cpu"), whole,
                                                      tokens)
        torch.save(out, os.path.join(out_dir, f"rank{world}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("seqsplit")
    init, ref, later = _jax_side()
    np.savez(tmp / "init.npz", **init)
    ranks = {}
    for world in WORLDS:
        mp.spawn(_rank_main, args=(world, str(tmp / f"pg{world}"), str(tmp / "init.npz"),
                                   str(tmp)), nprocs=world)
        ranks[world] = [torch.load(tmp / f"rank{world}_{r}.pt", weights_only=False)
                        for r in range(world)]
    return ranks, ref, later


def _world(case):
    return 2 if CASES[case][3] == "d2" else 4


@pytest.mark.parametrize("case", list(CASES))
def test_serve_matches_repro(runs, case):
    """Prefill and four decode steps: every rank returns the full (B, V)
    logits, equal on every rank and within 2e-4 of repro's one-device
    logits."""
    ranks, ref, _ = runs
    outs = [r[case]["logits"] for r in ranks[_world(case)]]
    for got in outs[1:]:
        assert torch.equal(got, outs[0]), case
    assert outs[0].shape == ref[case].shape
    np.testing.assert_allclose(outs[0].numpy(), ref[case], err_msg=case, **TOL)


def test_cache_layout_per_case(runs):
    """What each rank caches: batch 3 or 1 on "data" ranks holds every row
    and its slice of the positions (16 / n); batch 2 on (pod=2, data=2) its
    row and every position; a cache of 30 on 4 data ranks stays whole; the
    recurrent states hold every row; under "model" the KV heads (qwen) or
    their dims (the head-dim split) split as before."""
    ranks = runs[0]
    k = {case: ranks[_world(case)][0][case]["cache"] for case in CASES}
    assert k["qwen_b1_d2"]["k"] == (2, 1, 8, 2, 16)
    assert k["qwen_b3_d2"]["k"] == (2, 3, 8, 2, 16)
    assert k["qwen_b1_d2m2"]["k"] == (2, 1, 8, 1, 16)
    assert k["qwen_b3_d2m2"]["k"] == (2, 3, 8, 1, 16)
    assert k["headdim_b3_d2m2"]["k"] == (2, 3, 8, 3, 4)
    assert k["qwen_b2_p2d2"]["k"] == (2, 1, 16, 2, 16)
    assert k["qwen_b1_d4"]["k"] == (2, 1, 4, 2, 16)
    assert k["qwen_b3_s30_d4"]["k"] == (2, 3, 30, 2, 16)
    assert k["jamba_b3_d2"]["h"][1] == 3 and k["xlstm_b3_d2"]["C"][1] == 3


def test_gathered_partials_are_counted(runs):
    """(iv) A prefill issues no gather of partials; a decode step over a
    split cache one per attention layer, each rank putting B x Hq_local x
    (D + 1) fp32 into it (Hq_local with the head-dim split's zero heads);
    over a whole cache none. Rows split over "data" (case 2) or every row
    on every rank: the logits' gather over "model" only where it exists."""
    from repro_torch.configs import registry
    from repro_torch.models import layers as L

    ranks = runs[0]
    for case, (arch, B, S, mesh_name) in CASES.items():
        cfg = _cfg(registry, arch)
        (sizes, names) = MESHES[mesh_name]
        M = sizes[names.index("model")]
        split = B % sizes[names.index("data")] != 0 and S % sizes[names.index("data")] == 0
        A = sum(kind == "attn" for kind in cfg.block_types())
        assert A or arch == "xlstm"
        for r, out in enumerate(ranks[_world(case)]):
            res = out[case]
            if M > 1:
                sp = L.head_split(cfg, M, res["coords"]["model"])
                heads = sp.q[1] - sp.q[0] + sum(sp.pad)
            else:
                heads = cfg.n_heads
            assert res["counts"][0]["gather_partials"] == (0, 0), (case, r)
            for step in res["counts"][1:]:
                want = (A, A * B * heads * (cfg.head_dim + 1) * 4) if split else (0, 0)
                assert step["gather_partials"] == want, (case, r, step)
                assert step["gather_from_model"][0] == (M > 1 and cfg.vocab_size % M == 0)
    # The head-dim split pads 6 query heads to 8 on either rank (2 layers).
    assert ranks[4][0]["headdim_b3_d2m2"]["counts"][1]["gather_partials"][1] == 2 * 3 * 8 * 9 * 4


@pytest.mark.parametrize("case", LATER)
def test_multi_token_steps_match_one_rank(runs, case):
    """(v) Two 3-token cached steps past the prompt (positions 8-10, then
    11-13, across the slices' bounds): every rank's logits equal, within
    2e-4 of ``repro``'s one-device steps and of one rank's whole cache."""
    ranks, _, ref = runs
    outs = [r[case]["later"]["multi"] for r in ranks[_world(case)]]
    for got in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, outs[0])), case
    one = ranks[_world(case)][0][case]["later_one"]["multi"]
    assert len(outs[0]) == len(one) == len(ref[case]["multi"]) == 2
    for got, one_, ref_ in zip(outs[0], one, ref[case]["multi"]):
        assert got.shape == ref_.shape
        np.testing.assert_allclose(got.numpy(), ref_, err_msg=case, **TOL)
        np.testing.assert_allclose(got.numpy(), one_.numpy(), err_msg=case, **TOL)


@pytest.mark.parametrize("case", LATER)
def test_per_row_positions_match_one_rank(runs, case):
    """(v) A (B,) position of the global batch, one per row (7, 3, 5: rows
    in different slices, or on different ranks), then a 1-token and a
    3-token step: logits within 2e-4 of ``repro``'s one-device steps at the
    same positions and of one rank's whole cache on every rank, the global
    position advanced on the tensor."""
    ranks, _, ref = runs
    B = CASES[case][1]
    for r in ranks[_world(case)]:
        later, one = r[case]["later"], r[case]["later_one"]
        assert len(later["rows"]) == len(one["rows"]) == len(ref[case]["rows"]) == 2
        for got, one_, ref_ in zip(later["rows"], one["rows"], ref[case]["rows"]):
            assert got.shape == ref_.shape
            np.testing.assert_allclose(got.numpy(), ref_, err_msg=case, **TOL)
            np.testing.assert_allclose(got.numpy(), one_.numpy(), err_msg=case, **TOL)
        assert later["pos"].tolist() == [p + 4 for p in ROW_POS[:B]]


def test_seq_split_collectives_equal_the_dry_run(runs):
    """Batch 1 on (data 4, model 1), every cache split over the sequence:
    each call's collectives on rank 0 (the prefill, then each decode step's
    gather of the partials) as gloo counted them equal the dry-run's on a
    fake (4, 1) group, and the calls chip_smoke.py's ``seq_collectives``
    derives."""
    import chip_smoke as cs
    import torch_fake_group
    from repro_torch.configs import registry

    arch, B, S, mesh = CASES["qwen_b1_d4"]
    cfg = _cfg(registry, arch)
    fake = torch_fake_group.run(program="serve", arch=ARCHS[arch][0], mesh=MESHES[mesh][0],
                                names=MESHES[mesh][1], max_len=S, batch=B, prompt=PROMPT,
                                decodes=DECODES)
    got = runs[0][4][0]["qwen_b1_d4"]["collectives"]
    assert got == fake
    for i, call in enumerate(got):
        tokens, pos = (PROMPT, 0) if i == 0 else (1, PROMPT + i - 1)
        want = cs.seq_collectives(cfg, B, tokens, pos, 4, 1, cfg.n_heads)[1]
        assert {n: c for n, (c, _) in call["collective_calls"].items()} == \
            {n: c for n, c in want.items() if c}
