"""The fused LSTM's grid design on the card: past the width a thread-block
cluster holds (H > 436 forward and 440 backward in f32, H > 512 in bf16),
at T > 1, the forward and backward launchers take their grid kernels
(``lstm_fwd_grid_kernel``, ``lstm_bwd_grid_kernel``: R split across a row
group of CTAs, one barrier a step, h and the partial carries through L2).

These tests need the card and skip without one (run them there with
``python -m pytest -m cuda tests/test_torch_*.py``). The shapes and plans
the launchers choose are held on the CPU in
``tests/test_torch_kernel_requires.py``. This file imports no JAX: on the
card the kernels are held against the port's plain versions.

Tolerances: f32 1e-4 abs (the kernels sum h @ R and the carries in another
order than the plain versions); bf16 |a - b| <= 2^-7 (1 + |b|) on the
forward's outputs (one bf16 step) and 1e-2 (1 + |b|) on the backward's
(dg enters the product rounded to bf16, and a carry summed in another
order can tip a rounding), as chip_smoke.py's phases 3 and 6; the layer's
gradients 1e-4 of max(1, max |plain|) in f32 (TOL_GRAD of chip_smoke.py).
"""

import pytest
import torch

from deeplearning4j_tpu_torch.ops.cuda import fused_lstm
from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import (
    FUSED_LSTM, FUSED_LSTM_BWD, fused_lstm_bwd_recurrence, fused_lstm_layer,
    fused_lstm_recurrence, plain_bwd_recurrence, plain_recurrence,
)
from deeplearning4j_tpu_torch.ops.recurrent import lstm_layer, project_gates

#: (B, T, F, H, peephole, reverse): a ragged width (650 is no multiple of
#: a CTA's 8 or 16 units) and rows (8 of a group's), reversed with
#: peepholes; TextGenerationLSTM(1024)'s width at a short T
SHAPES = [(8, 4, 77, 650, True, True), (64, 8, 256, 1024, False, False)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _layer_inputs(device, g, B, T, F, H, peep, dt):
    rnd = lambda *s, k=1.0: (torch.randn(*s, device=device, generator=g)  # noqa
                             * k).to(dt)
    # R's scale keeps the recurrent gain near 1 at H = 1024
    return dict(x=rnd(B, T, F), h0=rnd(B, H, k=0.5), c0=rnd(B, H, k=0.5),
                W=rnd(F, 4 * H, k=0.1), R=rnd(H, 4 * H, k=0.03),
                b=rnd(4 * H, k=0.1), p=rnd(3 * H, k=0.1) if peep else None,
                g_out=rnd(B, T, H), g_h=rnd(B, H), g_c=rnd(B, H))


def _within(got, want, dt, bf16_tol):
    assert bool(torch.isfinite(got.float()).all())
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        got, want = got.float(), want.float()
        assert bool(((got - want).abs() <= bf16_tol * (1 + want.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,F,H,peep,rev", SHAPES)
def test_grid_pair_against_plain_on_card(cuda_device, dtype, B, T, F, H,
                                         peep, rev):
    """Both launchers choose the grid design, as their Python mirrors do;
    the forward's out, hT, cT and reserve against ``plain_recurrence``
    (out bit-equal with and without the reserve); the backward's dg and
    dc0 against ``plain_bwd_recurrence`` on the kernel's own reserve; one
    launch each."""
    dt = getattr(torch, dtype)
    for launcher, mirror in ((fused_lstm.launcher_design,
                              fused_lstm.fwd_design),
                             (fused_lstm.launcher_bwd_design,
                              fused_lstm.bwd_design)):
        design = launcher(T, B, H, dt)
        assert design == mirror(T, B, H, dt)
        assert design.kind == "grid", design
    g = torch.Generator(device=cuda_device).manual_seed(H + T)
    a = _layer_inputs(cuda_device, g, B, T, F, H, peep, dt)
    xg = project_gates(a["x"], a["W"], a["b"], 1.0, rev)
    args = (xg, a["R"], a["h0"], a["c0"], a["p"])
    before = (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches)
    got = fused_lstm_recurrence(*args)
    *got_r, reserve = fused_lstm_recurrence(*args, save_residuals=True)
    dout = a["g_out"].transpose(0, 1)
    dout = (dout.flip(0) if rev else dout).contiguous()
    dg, dc0 = fused_lstm_bwd_recurrence(reserve, a["R"], a["c0"], dout,
                                        a["g_c"], a["p"])
    torch.cuda.synchronize()
    assert (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches) == (
        before[0] + 2, before[1] + 1)
    assert all(torch.equal(x, y) for x, y in zip(got, got_r))
    *want, p_res = plain_recurrence(*args, save_residuals=True)
    for x, y in zip(got, want):
        assert x.dtype == dt
        _within(x, y, dt, 2 ** -7)
    assert reserve.dtype == torch.float32
    _within(reserve, p_res, dt, 2 ** -7)
    p_dg, p_dc0 = plain_bwd_recurrence(reserve, a["R"], a["c0"], dout,
                                       a["g_c"], a["p"])
    for x, y in ((dg, p_dg), (dc0, p_dc0)):
        assert x.dtype == torch.float32
        _within(x, y, dt, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,F,H,peep,rev", SHAPES)
def test_grid_layer_grads_against_autograd_on_card(cuda_device, B, T, F, H,
                                                   peep, rev):
    """FusedLSTMFunction through both grid kernels: the layer's six or
    seven gradients against autograd through the plain lowering on the
    card (f32; in bf16 autograd rounds other intermediates than the
    kernels, whose recurrences are held above)."""
    g = torch.Generator(device=cuda_device).manual_seed(3 * H + T)
    a = _layer_inputs(cuda_device, g, B, T, F, H, peep, torch.float32)
    names = ["x", "h0", "c0", "W", "R", "b"] + (["p"] if peep else [])

    def grads(fn):
        leaves = {n: a[n].clone().requires_grad_() for n in names}
        ys, (h, c) = fn(leaves["x"], leaves["h0"], leaves["c0"],
                        leaves["W"], leaves["R"], leaves["b"],
                        peephole=leaves.get("p"), forget_gate_bias=1.0,
                        reverse=rev)
        return torch.autograd.grad((ys, h, c), list(leaves.values()),
                                   (a["g_out"], a["g_h"], a["g_c"]))

    before = (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches)
    got = grads(fused_lstm_layer)
    torch.cuda.synchronize()
    assert (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    assert FUSED_LSTM.reserves >= 1
    want = grads(lstm_layer)  # the plain lowering, autograd through it
    for n, x, y in zip(names, got, want):
        scale = max(1.0, float(y.abs().max()))
        torch.testing.assert_close(x, y, atol=1e-4 * scale, rtol=0, msg=n)


@pytest.mark.cuda
def test_grid_pair_is_the_same_run_to_run(cuda_device):
    """Each owner sums its group's partial carries in rank order, and the
    forward's sums meet in shared memory in a fixed order: out, the
    reserve, dg and dc0 are bit for bit the same run to run."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    a = _layer_inputs(cuda_device, g, 64, 8, 256, 1024, False,
                      torch.float32)
    xg = project_gates(a["x"], a["W"], a["b"], 0.0, False)
    dout = a["g_out"].transpose(0, 1).contiguous()

    def run():
        out, _, _, res = fused_lstm_recurrence(xg, a["R"], a["h0"], a["c0"],
                                               save_residuals=True)
        return (out, res) + fused_lstm_bwd_recurrence(res, a["R"], a["c0"],
                                                      dout, a["g_c"])

    first = run()
    for _ in range(2):
        assert all(torch.equal(x, y) for x, y in zip(first, run()))
