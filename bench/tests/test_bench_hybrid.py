"""The hybrid cell's files on the CPU: the layout against the program's
tree at the configuration's own sizes (fake tensors), the frozen work
against hand counts, the readers, and whole runs of the cell at a small
size: the sound program correct, an altered token and the fp8 control
not."""
import copy
import dataclasses
import math
import time

import pytest
import torch

from bench import drive_serve_hybrid, harness, hybrid, program, spec, trace  # noqa: F401
from bench import work_hybrid

CELL = "ai21-jamba2-mini.prefill-8k"
CPU = torch.device("cpu")


def small_hybrid(**traffic):
    """The cell at a CPU size (8 layers, one period; width 64, heads 4 / 2 of
    16, d_ff 96, vocabulary 256, 4 of 8 experts held, d_state 8, dt_rank 8,
    chunks of 8) with its traffic changed as given; its limits as the cell
    has them."""
    cell = spec.cell(CELL)
    c = copy.deepcopy(cell.config)
    c.update(num_hidden_layers=8, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=96, vocab_size=256, num_experts=4, mamba_d_state=8,
             mamba_dt_rank=8, published={"num_experts": 8})
    c["port"].update(held_first=2, chunk_size=8)
    t = copy.deepcopy(cell.traffic)
    t.update(dict(batch=2, generate=4, check_sample=3,
                  prompt={"median": 24, "sigma": 0.0, "min": 24, "max": 24}), **traffic)
    return spec.Cell(cell.name, cell.chips, c, t, dict(cell.limits), cell.end_to_end,
                     cell.per_layer)


def test_layout_is_the_programs_tree_at_full_size():
    """29.02 B parameters, 22.55 B of them in the held experts: the program's
    tree as fake tensors (no memory) against the layout."""
    from repro_torch.models import zoo

    config = spec.cell(CELL).config
    m = hybrid.dims(config)
    model = zoo.build(hybrid.arch_config(config), dtype=torch.bfloat16, device="cpu")
    hybrid.check_layout(m, model.param_shapes(), torch.bfloat16)
    experts = sum(math.prod(s) for p, s, _, _ in hybrid.layout(m) if p[-1].endswith("_e"))
    assert (experts, hybrid.n_params(m) - experts) == (22_548_578_304, 6_473_166_720)


def test_mamba_work_by_hand():
    m = hybrid.dims(spec.cell(CELL).config)
    # One Mamba layer, 2 rows of 8,192: d 4096, d_in 8192, N 16, dt_rank 256, K 4.
    S = 16_384
    mm = 2 * S * (4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096)
    other = S * 8192 * (7 * 16 + 8)
    weights = 2 * (4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096 + 4 * 8192 + 8192) \
        + 4 * (8192 * 16 + 2 * 8192 + 288)
    nbytes = weights + 2 * S * 4096 * 2 + 2 * (4 * 8192 * 16 + 2 * 3 * 8192)
    assert work_hybrid.mamba_work(m, 2, 8192) == (mm, other, nbytes)
    assert work_hybrid.mamba_bound_s(m, 2, 8192) == pytest.approx(mm / 989e12)
    # One token of one row: the bytes bound it.
    mm1, _, b1 = work_hybrid.mamba_work(m, 1, 1)
    assert mm1 == mm // S and work_hybrid.mamba_bound_s(m, 1, 1) == pytest.approx(b1 / 3.35e12)


def test_serve_flops_by_hand():
    """The small cell: 7 Mamba layers, 1 attention layer, 4 MoE layers
    meeting 2 x 4 / 8 = 1 expert a token, 4 dense FFNs."""
    m = hybrid.dims(small_hybrid().config)
    mamba = 64 * 256 + 128 * 24 + 8 * 128 + 128 * 64
    attn = 64 * (64 + 2 * 32) + 64 * 64
    ffn = 3 * 64 * 96
    moe = 64 * 8 + ffn
    weights = 7 * mamba + attn + 4 * ffn + 4 * moe
    for prompt, gen in ((24, 4), (10, 1)):
        fed = prompt + gen - 1
        want = (2 * weights * fed + 2 * 64 * 256 * gen + 4 * 16 * 4 * fed * (fed + 1) // 2
                + 7 * fed * 128 * (7 * 8 + 8))
        assert work_hybrid.serve_request_flops(m, prompt, gen) == want


def run(cell, seed=2**31 + 13):
    return harness.run(cell, seed, 0.2, False, time.perf_counter(), CPU)


def test_sound_run_is_correct():
    cell = small_hybrid()
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"ttft_p90_ms", "serve_tok_s", "setup_s"}


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.runtime import serve

    build = serve.build_serve_fns

    def patched(*args, **kwargs):
        prefill_fn, decode_fn = build(*args, **kwargs)

        def altered(params, cache, batch):
            logits, cache = decode_fn(params, cache, batch)
            wrong = (logits.argmax(-1) + 1) % logits.shape[-1]
            return logits.scatter(1, wrong[:, None], float(logits.max()) + 1.0), cache
        return prefill_fn, altered
    monkeypatch.setattr(serve, "build_serve_fns", patched)
    out = run(small_hybrid())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [2**31 + 17, 5])
def test_fp8_control_moves_the_gap(seed):
    """The float8 control's mean gap at a CPU size reads 0.03-0.15, under the
    cell's limit, which is set on the chip at the cell's own sizes (PERF.md
    §4: the control reads 0.5 and more there, the program 0.05 and less).
    Here it stands at least ten times above the program's own."""
    cell = small_hybrid()
    prog = drive_serve_hybrid.Program(cell, seed, CPU)
    prog.window(0.0)
    prog.window(0.0)
    evidence = prog.evidence()
    ref = drive_serve_hybrid.reference(cell, seed, CPU, evidence)
    low = drive_serve_hybrid.reference(cell, seed, CPU, evidence, prec="fp8")
    assert drive_serve_hybrid.control_gap(ref, ref) == 0
    program = drive_serve_hybrid.compare(evidence, ref)["token_gap_mean"]
    assert drive_serve_hybrid.control_gap(ref, low) > max(10 * program, 0.02)


def test_padded_batch_is_refused():
    cell = small_hybrid(prompt={"median": 24, "sigma": 0.6, "min": 8, "max": 40})
    with pytest.raises(ValueError, match="no padding"):
        run(cell)


def _op(name, start, end, thread=1):
    return trace.Op(name, thread, start, end)


def test_readers_over_a_made_trace():
    """Two Mamba spans in the prefill and one in a decode step, a MoE span:
    the readers put each kernel under its span."""
    m = hybrid.dims(spec.cell(CELL).config)
    ops = {1: _op("serve.prefill", 0, 1000), 2: _op("ssm.mamba", 10, 100),
           3: _op("aten::mm", 20, 30), 4: _op("ssm.mamba", 200, 300), 5: _op("aten::mm", 210, 220),
           6: _op("moe.experts", 400, 500), 7: _op("aten::mm", 410, 420),
           8: _op("serve.decode", 2000, 3000), 9: _op("ssm.mamba", 2010, 2100),
           10: _op("aten::mm", 2020, 2030)}
    dev = [trace.Device("k", 1_000_000, 1_000_000 + 10**9, "kernel", 3),
           trace.Device("k", 0, 10**9, "kernel", 5),
           trace.Device("k", 0, 2 * 10**6, "kernel", 7),
           trace.Device("k", 0, 3 * 10**6, "kernel", 10)]
    tr = trace.Trace(1.0, 1, 0, dev, ops, [])
    rec = {"trace": tr, "hybrid": m, "prefill_shape": (2, 8192)}
    assert spec.reader("mamba_ms.serve")(rec) == pytest.approx(2003.0)
    assert spec.reader("moe_ms.serve")(rec) == pytest.approx(2.0)
    bound = 2 * work_hybrid.mamba_bound_s(m, 2, 8192)
    assert spec.reader("mamba_roofline.prefill")(rec) == pytest.approx(100 * bound / 2.0)
    for name in ("mamba_ms.serve", "moe_ms.serve", "mamba_roofline.prefill"):
        assert spec.reader(name)({"trace": None}) is None
    empty = dataclasses.replace(tr, ops={k: v for k, v in ops.items()
                                         if not v.name.startswith(("ssm.", "moe."))})
    assert spec.reader("mamba_roofline.prefill")({**rec, "trace": empty}) is None
    reqs = [{"prompt": 8192, "generated": 16}] * 4
    got = spec.reader("mfu.serve_hybrid")({"requests": reqs, "hybrid": m, "window_s": 50.0})
    want = 100 * 4 * work_hybrid.serve_request_flops(m, 8192, 16) / 50.0 / 989e12
    assert got == pytest.approx(want) and 0 < got < 100
    # A MoE layer meets top_k x held / experts = 1 expert a token: the dense
    # FFN's weights and the router's.
    assert work_hybrid.layer_matmul_params(m, 1) - work_hybrid.layer_matmul_params(m, 0) \
        == 4096 * 16
