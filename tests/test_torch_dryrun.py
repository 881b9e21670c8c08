"""The port's dry-run (``launch/dryrun.py``, ``launch/hlo_analysis.py``) on
the CPU: the ring estimates against ``repro``'s, each kernel's abstract
path and work formula, the parameter trees and per-rank shards of all ten
archs against ``repro``'s, closed-form FLOPs of a reduced model, the CLI.

The dry-run traces on fake tensors; on this host (PyTorch without CUDA)
they lie on "meta", which the port runs as it runs CUDA (every device but
the CPU takes the kernels' path). ``chip_smoke.py`` phase 25 holds the same
counts on fake CUDA tensors and a real run on the card to each other.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "internvl2-2b", "jamba-v0.1-52b", "llama4-scout-17b-a16e",
         "musicgen-large", "phi3-medium-14b", "qwen1.5-4b", "qwen3-1.7b", "qwen3-4b",
         "xlstm-1.3b")


def _repro_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` left as it was
    (the module sets a 512-device host platform for its own process)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


# ----------------------------------------------------------- ring estimates


def test_ring_estimates_equal_repro():
    """``collective_bytes`` on tests/test_dryrun_small.py's four ops gives
    ``repro``'s ``parse_collectives`` total, op by op."""
    hlo = """
  %ag = bf16[16,512]{1,0} all-gather(%x), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%y), replica_groups=[16,16]<=[256], to_apply=%add
  %rs = bf16[4,128]{1,0} reduce-scatter(%z), replica_groups=[16,16]<=[256], dimensions={0}
  %cp = bf16[8,8]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
"""
    want = _repro_dryrun().parse_collectives(hlo, 256)
    ops_ = (("all-gather", 16 * 512 * 2, 16), ("all-reduce", 1024 * 4, 16),
            ("reduce-scatter", 4 * 128 * 2, 16), ("collective-permute", 8 * 8 * 2, 256))
    got = {k: H.collective_bytes(k, r, g) for k, r, g in ops_}
    assert got == want["bytes_by_kind"]
    assert sum(got.values()) == want["total_bytes"]
    assert H.collective_bytes("all-to-all", 4096, 4) == 4096 * 3 / 4


def test_collectives_record_kinds_groups_and_bytes():
    """``Collectives`` wraps the ``torch.distributed`` functions while it is
    open: per call repro's kind, the result and input bytes, the group
    size; the functions are restored after."""
    orig = {n: getattr(torch.distributed, n) for n in H.KINDS}
    fake = {n: (lambda *a, **k: None) for n in H.KINDS}
    sizes = {None: 8}
    try:
        for n, f in fake.items():
            setattr(torch.distributed, n, f)
        get_size = torch.distributed.get_world_size
        torch.distributed.get_world_size = lambda group=None: sizes[group]
        c = H.Collectives()
        with c:
            torch.distributed.all_reduce(torch.zeros(10))
            torch.distributed.all_gather_into_tensor(torch.zeros(80), torch.zeros(10))
            torch.distributed.reduce_scatter_tensor(torch.zeros(10), torch.zeros(80))
            torch.distributed.all_to_all_single(torch.zeros(6), torch.zeros(4), [1] * 8, [1] * 8)
            torch.distributed.all_gather([torch.zeros(2)] * 8, torch.zeros(2))
        assert torch.distributed.all_reduce is fake["all_reduce"]
    finally:
        torch.distributed.get_world_size = get_size
        for n, f in orig.items():
            setattr(torch.distributed, n, f)
    assert c.calls == {"all_reduce": [1, 40], "all_gather_into_tensor": [1, 40],
                       "all_gather": [1, 8], "reduce_scatter_tensor": [1, 320],
                       "all_to_all_single": [1, 16]}
    s = c.summary()
    assert s["collective_counts"] == {"all-reduce": 1, "all-gather": 2, "reduce-scatter": 1,
                                      "all-to-all": 1}
    assert s["collective_by_kind"]["all-gather"] == 320 * 7 / 8 + 64 * 7 / 8
    assert s["collective_by_kind"]["reduce-scatter"] == 40 * 7
    assert s["collective_input_bytes"] == {"all-reduce": 40, "all-gather": 48,
                                           "reduce-scatter": 320, "all-to-all": 16}


# -------------------------------------------------- the kernels, abstractly

BF = torch.bfloat16
# Each kernel at two shapes: phase 3's full-width one (its bound) and a
# reduced one. Formulas as chip_smoke.py's phase 3 wrote them by hand
# before the work formulas existed: (operations, bytes).
K1 = [  # B, Tq, Tk, Hq, Hkv, D, q_offset, kv_len, dtype
    (cs.B_SERVE, cs.PROMPT, cs.MAX_LEN, cs.HQ, cs.HKV, cs.HD, 0, cs.PROMPT, BF),
    (2, 61, 80, 4, 2, 16, 0, 61, torch.float32),
]
K23 = [(cs.B_TRAIN, cs.SEQ_TRAIN, cs.HQ, cs.HKV, cs.HD, BF), (2, 77, 4, 2, 16, torch.float32)]
K4 = [(cs.B_SERVE, cs.MAX_LEN, cs.HQ, cs.HKV, cs.HD, cs.DECODE_KV, BF),
      (3, 80, 4, 2, 16, 37, torch.float32)]
K4L = [(1, cs.SEQ_SLICE, cs.HQ, cs.HKV, cs.HD, cs.SEQ_SLICE, BF),
       (2, 333, 8, 2, 64, 300, torch.float32)]
K5 = [(cs.B_SERVE * cs.PROMPT, cs.D_MODEL, BF), (333, 100, torch.float32)]


def _hand_k1(B, Tq, Tk, Hq, Hkv, D, el):  # prefill at q_offset 0, kv_len Tq
    pairs = B * Hq * Tq * (Tq + 1) // 2
    return 4 * D * pairs, 2 * B * Tq * Hq * D * el + 2 * B * Tq * Hkv * D * el + B * Hq * Tq * 4


def _hand_bwd(B, T, Hq, Hkv, D, el, dkv):
    pairs = B * Hq * T * (T + 1) // 2
    qb, kb, stat = B * T * Hq * D * el, B * T * Hkv * D * el, B * Hq * T * 4
    if dkv:
        return 8 * D * pairs, 2 * qb + 2 * kb + 2 * stat + 2 * kb
    return 6 * D * pairs, 2 * qb + 2 * kb + 2 * stat + qb


def _hand_k4(B, Hq, Hkv, D, kv, el, lse):
    if lse:
        return 4 * D * Hq * B * kv, B * Hq * D * el + 2 * B * kv * Hkv * D * el + B * Hq * D * 4 \
            + B * Hq * 4
    return 4 * D * Hq * B * kv, 2 * B * Hq * D * el + 2 * B * kv * Hkv * D * el


def _cases():
    """(name, fn over tensors on a device, inputs' shapes and types, the
    plain version, the hand-written work)."""
    out = []
    for B, Tq, Tk, Hq, Hkv, D, qo, kl, dt in K1:
        el = torch.finfo(dt).bits // 8
        out.append(("flash_attention",
                    lambda q, k, v, qo=qo, kl=kl: fa.flash_attention_fwd(q, k, v, q_offset=qo,
                                                                         kv_len=kl),
                    [(B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)], dt,
                    lambda q, k, v, qo=qo, kl=kl: (
                        ref.attention(q, k, v, q_offset=qo, kv_len=kl),
                        ref.attention_lse(q, k, q_offset=qo, kv_len=kl)),
                    _hand_k1(B, Tq, Tk, Hq, Hkv, D, el)))
    for B, T, Hq, Hkv, D, dt in K23:
        el = torch.finfo(dt).bits // 8
        shapes = [(B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, Hq, D), (B, Hq, T),
                  (B, Hq, T)]
        out.append(("flash_attention_dq", fa.launch_dq, shapes, dt,
                    lambda q, k, v, do, lse, delta: ref.attention_dq(q, k, v, do, lse.float(),
                                                                     delta.float()),
                    _hand_bwd(B, T, Hq, Hkv, D, el, False)))
        out.append(("flash_attention_dkv", fa.launch_dkv, shapes, dt,
                    lambda q, k, v, do, lse, delta: ref.attention_dkv(q, k, v, do, lse.float(),
                                                                      delta.float()),
                    _hand_bwd(B, T, Hq, Hkv, D, el, True)))
    for cases, lse in ((K4, False), (K4L, True)):
        for B, S, Hq, Hkv, D, kl, dt in cases:
            el = torch.finfo(dt).bits // 8
            out.append(("decode_attention_lse" if lse else "decode_attention",
                        lambda q, k, v, kl=kl, lse=lse: dec.decode_attention(q, k, v, kl, lse=lse),
                        [(B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], dt,
                        lambda q, k, v, kl=kl, lse=lse: ref.decode_attention(q, k, v, kl, lse=lse),
                        _hand_k4(B, Hq, Hkv, D, kl, el, lse)))
    for rows, d, dt in K5:
        el = torch.finfo(dt).bits // 8
        out.append(("rmsnorm", rms.rmsnorm, [(rows, d), (d,)], dt, ref.rmsnorm,
                    (4 * rows * d, 2 * rows * d * el + d * 4)))
    return out


CASES = _cases()


def _inputs(shapes, dt, device, gen=None):
    """Inputs of a case: the stats of K2 / K3 (5th and 6th) and K5's scale
    (2nd of 2) in fp32."""
    out = []
    for i, s in enumerate(shapes):
        t = dt if not ((len(shapes) == 6 and i >= 4) or (len(shapes) == 2 and i == 1)) \
            else torch.float32
        out.append(torch.empty(s, dtype=t, device=device) if gen is None
                   else torch.randn(s, generator=gen, dtype=torch.float32).to(t))
    return out


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}-{i % 2}" for i, c in enumerate(CASES)])
def test_kernel_abstract_path(case, monkeypatch):
    """A kernel's custom op on fake tensors: the plain version's output
    shapes and types (on small real CPU tensors of the same shape where the
    shape is small); the work counted by ``hlo_analysis.Count`` and by
    ``FlopCounterMode`` equals the hand-written formula of phase 3; no
    launch is counted and nothing is built."""
    from repro_torch.kernels import build

    name, fn, shapes, dt, plain, (ops_want, bytes_want) = CASES[case]

    def no_build(*a, **k):
        raise AssertionError("built a kernel on fake tensors")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(build, "build", no_build)
    ops.reset_launches()
    with FakeTensorMode():
        args = _inputs(shapes, dt, "meta")
        count = H.Count()
        with count:
            got = fn(*args)
        with FlopCounterMode(display=False) as flops:
            fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert count.kernel_calls == {name: 1}
    assert (count.flops, count.bytes_accessed) == (ops_want, bytes_want)
    assert flops.get_total_flops() == ops_want
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    if math.prod(shapes[0]) < 1e5:  # the plain version on real CPU tensors
        want = plain(*_inputs(shapes, dt, "cpu", torch.Generator().manual_seed(0)))
        want = want if isinstance(want, tuple) else (want,)
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(t.shape), t.dtype) for t in want]
    else:
        assert tuple(got[0].shape) == (shapes[0] if name != "flash_attention_dkv"
                                       else shapes[1])


def test_phase3_bounds_come_from_the_formulas():
    """chip_smoke.py's bound column at phase 3's shapes: the work formulas
    give the numbers the hand-written counts gave."""
    for name, _, shapes, dt, _, (ops_want, bytes_want) in CASES:
        with FakeTensorMode():
            t = _inputs(shapes, dt, "meta")
        if name == "flash_attention":
            work = fa.fwd_work(t[0], t[1], qo_s=0, kl_s=t[0].shape[1])
        elif name.startswith("flash_attention_d"):
            work = fa.bwd_work(t[0], t[1], dkv=name.endswith("dkv"))
        elif name.startswith("decode"):
            kl = next(c[5] for c in (K4 + K4L) if c[1] == shapes[1][1] and c[2] == shapes[0][1])
            work = dec.work(t[0], t[1], None, kl, lse=name.endswith("lse"))
        else:
            work = rms.work(t[0], t[1])
        assert work == (ops_want, bytes_want), name
        bound_dt = torch.float32 if name == "rmsnorm" else dt
        if bound_dt in cs.PEAK_OPS:
            assert cs.work_bound(work, bound_dt) == cs.bound_ms(bytes_want, ops_want, bound_dt)


def test_work_reads_per_row_lengths():
    """A (B,) kv_len or q_offset counts each row's own work; a fake one
    counts the whole cache."""
    q, k = torch.zeros(2, 8, 4, 16), torch.zeros(2, 20, 2, 16)
    ops_, _ = fa.fwd_work(q, k, torch.tensor([0, 4]), torch.tensor([8, 12]), causal=True)
    assert ops_ == 4 * 16 * 4 * (36 + (5 + 6 + 7 + 8 + 9 + 10 + 11 + 12))
    ops_, nbytes = dec.work(q[:, 0], k, torch.tensor([3, 50]))
    assert ops_ == 4 * 16 * 4 * (3 + 20)
    with FakeTensorMode():
        kl = torch.empty(2, dtype=torch.int32, device="meta")
        qf, kf = torch.empty(2, 4, 16, device="meta"), torch.empty(2, 20, 2, 16, device="meta")
        assert dec.work(qf, kf, kl, 20)[0] == 4 * 16 * 4 * 40


@pytest.mark.parametrize("T", [1, 3])
def test_cached_step_at_a_position_per_row_traces(T, monkeypatch):
    """One cached step of reduced qwen3-1.7b (T tokens a row) at a (B,)
    position, traced on meta tensors and counted as the dry-run counts a
    cell (``dryrun.Cell`` / ``count_cell``): the kernels' custom ops take
    the tensor offsets; a fake kv_len has no values, so K4 (T = 1) and K1
    (T = 3, its queries at the end of their keys) count the whole cache of
    every row; nothing is built or launched, nothing read on the host."""
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns
    from repro_torch.tree import tree_map

    def refused(*a, **k):
        raise AssertionError("built a kernel or read a value on the host")

    monkeypatch.setattr(build, "library", refused)
    monkeypatch.setattr(build, "build", refused)
    cfg = registry.get("qwen3-1.7b", reduced=True)
    B, S = 3, 64
    ops.reset_launches()
    with FakeTensorMode():
        model = zoo.build(cfg, dtype=dryrun.DTYPE, device="meta")
        params = model.load(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                                     model.param_shapes()))
        _, decode_fn = build_serve_fns(model, S, "meta")
        cache = model.init_cache(B, S)
        cache["pos"] = torch.empty(B, dtype=torch.int32, device="meta")
        batch = {"tokens": torch.empty((B, T), dtype=torch.int32, device="meta")}
        monkeypatch.setattr(torch.Tensor, "tolist", refused)
        monkeypatch.setattr(torch.Tensor, "item", refused)
        cell = dryrun.Cell(lambda: decode_fn(params, cache, batch),
                           {"parameters": params, "optimizer": None, "cache": cache["layers"],
                            "batch": batch})
        analysis, _, _ = dryrun.count_cell(cell)
    A, D = cfg.n_layers, cfg.head_dim
    name = "decode_attention" if T == 1 else "flash_attention"
    assert analysis["kernel_calls"][name] == A
    assert analysis["kernel_calls"]["rmsnorm"] == cs.rmsnorms_per_forward(cfg)
    assert set(analysis["kernel_calls"]) == {name, "rmsnorm"}
    assert ops.launch_counts() == {n: 0 for n in ops.KERNELS}
    with FakeTensorMode():  # one layer's launch alone, at the same shapes
        q = torch.empty(B, T, cfg.n_heads, D, dtype=dryrun.DTYPE, device="meta")
        k = torch.empty(B, S, cfg.n_kv_heads, D, dtype=dryrun.DTYPE, device="meta")
        offsets = torch.empty(B, dtype=torch.int32, device="meta")
        one = H.Count()
        with one:
            if T == 1:
                dec.decode_attention(q[:, 0], k, k, offsets)
            else:
                fa.flash_attention_fwd(q, k, k, q_offset=offsets, kv_len=offsets)
    if T == 1:  # every row reads the whole cache
        assert one.flops == 4 * D * cfg.n_heads * B * S
    else:  # the queries at S - T .. S - 1, each seeing the keys up to its own
        assert one.flops == 4 * D * cfg.n_heads * B * (T * (S - T) + T * (T + 1) // 2)
    assert one.kernel_calls == {name: 1}


# ------------------------------------------------ parameters and their shards

MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): (tuple(leaf.shape),
                                                                 str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_torch_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_and_shards_equal_repro(arch):
    """At full width, the port's ``param_shapes`` equals ``repro``'s
    ``jax.eval_shape(model.init)`` leaf by leaf (shape and type); on both
    production meshes each leaf's per-rank shard under the port's specs
    (FSDP and TP-only) equals the one ``repro``'s specs give."""
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo
    from repro.runtime import sharding as jshd
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import local_shape
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import zoo
    from repro_torch.runtime import sharding as shd

    jtpl = jax.eval_shape(jzoo.build(jregistry.get(arch), dtype=jnp.bfloat16).init,
                          jax.random.PRNGKey(0))
    ttpl = zoo.build(registry.get(arch), dtype=torch.bfloat16, device="cpu").param_shapes()
    want, got = _jax_leaves(jtpl), _torch_leaves(ttpl)
    assert got == want
    for sizes, names in MESHES.values():
        mesh = AbstractMesh.of(sizes, names)
        for fsdp in (True, False):
            jspecs = _jax_leaves(jax.tree_util.tree_map(
                lambda s: jax.ShapeDtypeStruct((len(s),), jnp.int8),
                jshd.tree_param_specs(jtpl, mesh, fsdp=fsdp),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
            jflat = {p: s for p, s in zip(_jax_leaves(jtpl),
                                          jax.tree_util.tree_leaves(
                                              jshd.tree_param_specs(jtpl, mesh, fsdp=fsdp),
                                              is_leaf=lambda x: isinstance(
                                                  x, jax.sharding.PartitionSpec)))}
            assert set(jspecs) == set(jflat)
            tspecs = shd.tree_param_specs(ttpl, mesh, fsdp=fsdp)
            tflat = {}

            def walk(t, s, prefix=""):
                for k in t:
                    if isinstance(t[k], dict):
                        walk(t[k], s[k], f"{prefix}{k}/")
                    else:
                        tflat[prefix + k] = local_shape(t[k].shape, s[k], mesh)
            walk(ttpl, tspecs)
            jshard = {p: local_shape(want[p][0], shd.P(*jflat[p]), mesh) for p in jflat}
            assert tflat == jshard, (arch, sizes, fsdp)


# ------------------------------------------------------ the CLI, closed forms

REPRO_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "seq_len", "global_batch",
              "param_count", "active_param_count", "timings_s", "memory_analysis",
              "cost_analysis", "collectives", "hlo_analysis"}
HLO_KEYS = {"flops", "collective_bytes", "collective_by_kind", "collective_counts",
            "bytes_accessed"}


def _cli(out, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
                        "--reduced", "--out", str(out), *args], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "failures=0" in r.stdout
    return r.stdout


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Reduced cells through the CLI, one process per mesh: every shape of
    qwen3-1.7b on (data 2, model 2) and on (1, 1), jamba's long_500k on
    (data 2, model 2)."""
    out = tmp_path_factory.mktemp("dryrun")
    _cli(out, "--all", "--arch", "qwen3-1.7b", "--mesh-shape", "2,2")
    _cli(out / "one", "--all", "--arch", "qwen3-1.7b", "--mesh-shape", "1,1")
    _cli(out, "--arch", "jamba-v0.1-52b", "--shape", "long_500k", "--mesh-shape", "2,2")
    return out


def _read(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["qwen3-1.7b__train_4k", "qwen3-1.7b__prefill_32k",
                                  "qwen3-1.7b__decode_32k", "jamba-v0.1-52b__long_500k"])
def test_cli_writes_repro_keys(artifacts, cell):
    """One reduced cell of each kind on a (2, 2) fake group: repro's artifact
    keys, its analysis keys, the rank traced, the kernels it reached."""
    r = _read(artifacts / "single" / f"{cell}.json")
    assert REPRO_KEYS <= set(r) and "error" not in r
    assert HLO_KEYS <= set(r["hlo_analysis"])
    assert r["n_devices"] == 4 and r["rank"] == 0 and r["device"] == "meta"
    assert r["memory_analysis"]["argument_bytes"] > 0
    assert r["memory_analysis"]["peak_bytes"] >= r["memory_analysis"]["argument_bytes"]
    assert r["collectives"]["total_bytes"] == r["hlo_analysis"]["collective_bytes"] > 0
    calls = r["hlo_analysis"]["kernel_calls"]
    want = {"train": {"flash_attention", "flash_attention_dq", "flash_attention_dkv",
                      "rmsnorm", "adamw_update"},
            "prefill": {"flash_attention", "rmsnorm"}, "decode": {"decode_attention", "rmsnorm"}}
    if cell.startswith("jamba"):  # batch 1 on data 2: the caches split over the sequence
        assert set(calls) == {"decode_attention_lse", "rmsnorm", "selective_scan"}
    else:
        assert set(calls) == want[r["kind"]]


def test_cli_skips_long_500k_of_full_attention(artifacts):
    r = _read(artifacts / "single" / "qwen3-1.7b__long_500k.json")
    assert set(r) == {"arch", "shape", "mesh", "skipped"}
    assert "full-attention" in r["skipped"]


def _matmul_flops_per_token(cfg):
    """2 x every weight matrix a token passes through: q, k, v, o and the
    SwiGLU FFN per layer, then the tied head."""
    d, hd = cfg.d_model, cfg.head_dim
    layer = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d \
        + 3 * d * cfg.d_ff
    return 2 * (cfg.n_layers * layer + d * cfg.vocab_size)


def _kernel_flops(cfg, B, T):
    """K1 (4 D per causal pair and query head) and K5 (4 per element: norm1,
    norm2, q and k norms of each layer, the final norm) of one forward."""
    pairs = B * cfg.n_heads * T * (T + 1) // 2
    k1 = 4 * cfg.head_dim * pairs
    layer_norms = 2 * B * T * cfg.d_model + B * T * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim
    return cfg.n_layers * k1, 4 * (cfg.n_layers * layer_norms + B * T * cfg.d_model)


def test_flops_closed_form(artifacts):
    """Reduced qwen3-1.7b on (1, 1): prefill's FLOPs are 2 x tokens x every
    weight matrix (the head at the last position only) plus the kernels'
    formulas; the train step's are the forward's matmuls three times (the
    backward takes dX and dW of each), the kernels of the forward twice
    (remat "dots" saves the matmuls and reruns the rest of each group) but
    the final norm once, K2 / K3 (6 D and 8 D a pair) per layer, and the
    AdamW kernel's 17 operations a parameter."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels.adamw import OPS_PER_ELEMENT
    from repro_torch.models import zoo
    from repro_torch.tree import leaves

    cfg = registry.get("qwen3-1.7b", reduced=True)
    d, V = cfg.d_model, cfg.vocab_size
    pre, train = SHAPES["prefill_32k"], SHAPES["train_4k"]
    B, T = pre.global_batch, pre.seq_len
    k1, k5 = _kernel_flops(cfg, B, T)
    head = 2 * d * V
    want = B * T * (_matmul_flops_per_token(cfg) - head) + B * head + k1 + k5
    got = _read(artifacts / "one" / "single" / "qwen3-1.7b__prefill_32k.json")
    assert got["cost_analysis"]["flops"] == want

    B, T = train.global_batch, train.seq_len
    k1, k5 = _kernel_flops(cfg, B, T)
    pairs = B * cfg.n_heads * T * (T + 1) // 2
    bwd = cfg.n_layers * (6 + 8) * cfg.head_dim * pairs
    final_norm = 4 * B * T * d
    n_params = sum(t.numel() for t in leaves(zoo.build(cfg, device="cpu").param_shapes()))
    want = 3 * B * T * _matmul_flops_per_token(cfg) + 2 * (k1 + k5) - final_norm + bwd \
        + OPS_PER_ELEMENT * n_params
    got = _read(artifacts / "one" / "single" / "qwen3-1.7b__train_4k.json")
    assert got["cost_analysis"]["flops"] == want
