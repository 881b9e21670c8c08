"""The frozen yardstick against the program's own formulas, and the model
arithmetic against hand counts."""
import pytest
import torch

from bench import model as bm
from bench import program, spec, work  # noqa: F401  (program: the port on sys.path)


def _t(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype)


@pytest.mark.parametrize("B,Tq,Tk,Hq,Hkv,D,qo,kl,causal", [
    (4, 4096, 4096, 16, 8, 64, 0, 4096, True),
    (16, 4064, 4080, 40, 10, 128, 0, 4064, True),
    (2, 128, 300, 8, 2, 128, 170, 298, True),
    (1, 64, 64, 4, 4, 16, 0, 64, False),
])
def test_flash_forward_work_equals_program(B, Tq, Tk, Hq, Hkv, D, qo, kl, causal):
    from repro_torch.kernels import flash_attention as fa

    q, k = _t((B, Tq, Hq, D)), _t((B, Tk, Hkv, D))
    assert work.flash_fwd(q.shape, k.shape, 2, qo, kl, causal) == \
        fa.fwd_work(q, k, None, None, qo, kl, causal)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", [(4, 4096, 16, 8, 64, True),
                                                  (2, 200, 40, 10, 128, False)])
def test_flash_backward_work_equals_program(B, T, Hq, Hkv, D, causal):
    from repro_torch.kernels import flash_attention as fa

    q, k = _t((B, T, Hq, D)), _t((B, T, Hkv, D))
    for dkv in (False, True):
        assert work.flash_bwd(q.shape, k.shape, 2, causal, dkv) == fa.bwd_work(q, k, causal, dkv)


def test_decode_and_rmsnorm_work_equal_program():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import rmsnorm as rms

    q, k = _t((16, 40, 128)), _t((16, 4080, 10, 128))
    lens = torch.arange(16, dtype=torch.int32) * 200 + 1000
    for lse in (False, True):
        assert work.decode(q.shape, k.shape, 2, lens.tolist(), lse) == \
            dec.work(q, k, lens, 0, lse)
        assert work.decode(q.shape, k.shape, 2, 3000, lse) == dec.work(q, k, None, 3000, lse)
    x, s = _t((8192, 5120)), _t((5120,), torch.float32)
    assert work.rmsnorm(x.shape, 2, 5120, 4) == rms.work(x, s)


def test_bound_of_call_reads_a_recorded_call():
    q, k = [4, 4096, 16, 64], [4, 4096, 8, 64]
    ops, nbytes = work.flash_fwd(q, k, 2, 0, 4096, True)
    got = work.bound_of_call("repro_torch::flash_attention_fwd", [q, k, k, [], [], [], [], [], []],
                             ["c10::BFloat16"] * 3 + [""] * 2 + ["Scalar"] * 4,
                             [None] * 5 + [0, 4096, True, 0.125])
    assert got == (max(ops / 989e12, nbytes / 3.35e12), "bfloat16")
    per_row = work.bound_of_call("repro_torch::flash_attention_fwd",
                                 [q, k, k, [4], [4], [], [], [], []],
                                 ["c10::BFloat16"] * 3 + ["int"] * 2 + ["Scalar"] * 4,
                                 [None] * 5 + [0, 0, True, 0.125])
    assert per_row is None


def test_parameter_counts_and_flops():
    g = bm.dims(spec.cell("granite-moe-1b-a400m.train-4k").config)
    p = bm.dims(spec.cell("phi3-medium-14b.prefill-long").config)
    assert bm.n_params(g) == 1_334_628_352  # 1.3346 B, as the registry arch: nothing cut
    assert round(bm.n_params(p) / 1e9, 2) == 13.96
    layer, head = work.matmul_params(g)
    # wq, wk, wv, wo; the router; 8 of 32 experts' three matrices.
    assert layer == 1024 * (1024 + 2 * 512) + 1024 * 1024 + 1024 * 32 + 8 * 3 * 1024 * 512
    assert head == 1024 * 49155
    step = work.train_step_flops(g, 4, 4096)
    attn = 3 * 4 * 4 * 64 * 16 * (4096 * 4097 // 2) * 24
    assert step == 6 * (24 * layer + head) * 16384 + attn
    one = work.serve_request_flops(p, 2000, 16)
    lp, hp = work.matmul_params(p)
    assert one == 2 * 40 * lp * 2015 + 2 * hp * 16 + 4 * 128 * 40 * (2015 * 2016 // 2) * 40


def test_layout_is_the_programs():
    from repro_torch.models import zoo

    for w in ("granite-moe-1b-a400m.train-4k", "phi3-medium-14b.prefill-long"):
        cell = spec.cell(w)
        model = zoo.build(program.arch_config(cell.config), device="cpu")
        bm.check_layout(bm.dims(cell.config), model.param_shapes())
        m = bm.dims(cell.config)
        assert model.cfg.param_count() + m.d == bm.n_params(m)  # its count skips the final norm
