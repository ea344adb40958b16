"""The port's LSTM backward (kernel wrapper and plain version) against the JAX
package and torch autograd.

On the CPU the port's ``fused_lstm_layer`` runs ``FusedLSTMFunction`` with
both kernels' plain versions, so its gradients come from the same assembly
code (dx, dh0, dW, dR, db, the peephole sums) as on the card. They are held
against ``jax.grad`` through the JAX package's Pallas ``fused_lstm_layer``
(interpret mode off-TPU, whose backward is ``_lstm_bwd_kernel``) and through
its scan lowering, on the same numpy inputs and cotangents: atol = rtol =
1e-5 in f32, as the forward's parity tests; only the order of the sums
differs. The ``cuda`` tests hold the backward kernel against its plain
version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas.fused_lstm import fused_lstm_layer as jax_fused
from deeplearning4j_tpu.ops.recurrent import lstm_layer as jax_scan
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.ops.cuda import fused_lstm as port_fused
from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import (
    FUSED_LSTM, FUSED_LSTM_BWD, fused_lstm_bwd_recurrence, fused_lstm_layer,
    fused_lstm_recurrence, plain_bwd_recurrence, plain_recurrence,
)
from deeplearning4j_tpu_torch.ops.recurrent import lstm_layer
from deeplearning4j_tpu_torch.ops.registry import get_op

TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ("x", "h0", "c0", "W", "R", "b", "p")


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


def _inputs(H, *, B=4, T=5, F=6, peephole=True, seed=0):
    """Inputs of one layer and cotangents for (out, hT, cT), as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(x=f(B, T, F), h0=f(B, H, scale=0.5), c0=f(B, H, scale=0.5),
                W=f(F, 4 * H, scale=0.3), R=f(H, 4 * H, scale=0.1),
                b=f(4 * H, scale=0.1),
                p=f(3 * H, scale=0.2) if peephole else None,
                g_out=f(B, T, H), g_h=f(B, H), g_c=f(B, H))


def _jax_grads(fn, a, dtype=jnp.float32, **kw):
    names = [n for n in NAMES if a[n] is not None]
    cot = [jnp.asarray(a[k], dtype) for k in ("g_out", "g_h", "g_c")]

    def loss(*args):
        d = dict(zip(names, args))
        out, (h, c) = fn(d["x"], d["h0"], d["c0"], d["W"], d["R"], d["b"],
                         peephole=d.get("p"), **kw)
        return sum((v.astype(jnp.float32) * g.astype(jnp.float32)).sum()
                   for v, g in zip((out, h, c), cot))

    args = [jnp.asarray(a[n], dtype) for n in names]
    grads = jax.grad(loss, argnums=tuple(range(len(names))))(*args)
    return {n: np.asarray(g.astype(jnp.float32)) for n, g in zip(names, grads)}


def _torch_grads(fn, a, dtype=torch.float32, device="cpu", **kw):
    names = [n for n in NAMES if a[n] is not None]
    args = {n: torch.tensor(a[n], device=device).to(dtype).requires_grad_()
            for n in names}
    out, (h, c) = fn(*(args[n] for n in NAMES[:6]), peephole=args.get("p"),
                     **kw)
    loss = sum((v.float() * torch.tensor(a[g], device=device).to(dtype).float()
                ).sum() for v, g in zip((out, h, c), ("g_out", "g_h", "g_c")))
    grads = torch.autograd.grad(loss, [args[n] for n in names])
    return {n: g for n, g in zip(names, grads)}


CASES = [
    pytest.param(H, peep, rev, fgb, id=f"H{H}-{'peep' if peep else 'nopeep'}"
                 f"-{'rev' if rev else 'fwd'}-fgb{fgb}")
    for H in (12, 200)
    for peep, rev, fgb in ((False, False, 0.0), (True, False, 1.0),
                           (False, True, 1.0), (True, True, 0.5))
]


@pytest.mark.parametrize("H,peep,rev,fgb", CASES)
def test_layer_grads_match_jax(H, peep, rev, fgb):
    """All seven gradients, with cotangents on out, hT and cT: port (plain
    fwd/bwd through FusedLSTMFunction) == JAX Pallas backward (interpret)
    == JAX scan autodiff, 1e-5."""
    a = _inputs(H, peephole=peep, seed=H + 7)
    kw = dict(forget_gate_bias=fgb, reverse=rev)
    port = _torch_grads(fused_lstm_layer, a, **kw)
    assert set(port) == {n for n in NAMES if a[n] is not None}
    for ref in (_jax_grads(jax_fused, a, **kw), _jax_grads(jax_scan, a, **kw)):
        for n, g in port.items():
            np.testing.assert_allclose(g.numpy(), ref[n], err_msg=n, **TOL)


@pytest.mark.parametrize("H,peep,rev", [(12, True, True), (200, False, False)],
                         ids=["H12-peep-rev", "H200-nopeep-fwd"])
def test_layer_grads_bf16_match_jax_pallas(H, peep, rev):
    """bf16: the port's gradients against the Pallas backward in interpret
    mode, which rounds the same places (dout and the final gradients to
    bf16, dg to bf16 for dg @ R^T, everything else f32). Tolerance 2^-7
    relative and absolute: one bf16 rounding step of the stored value, as
    the forward's bf16 parity test allows; the f32 sums run in different
    orders and can tip a value to its bf16 neighbour."""
    a = _inputs(H, peephole=peep, seed=H + 11)
    kw = dict(forget_gate_bias=1.0, reverse=rev)
    port = _torch_grads(fused_lstm_layer, a, dtype=torch.bfloat16, **kw)
    ref = _jax_grads(jax_fused, a, dtype=jnp.bfloat16, **kw)
    for n, g in port.items():
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), ref[n], atol=2 ** -7,
                                   rtol=2 ** -7, err_msg=n)


@pytest.mark.parametrize("H,peep", [(12, True), (33, False)],
                         ids=["H12-peep", "H33-nopeep"])
def test_bwd_recurrence_matches_autograd(H, peep):
    """The backward kernel's plain version == torch autograd through the
    forward's plain version: dg is the gradient of xg, dc0 that of c0."""
    a = _inputs(H, peephole=peep, B=3, T=7, seed=H)
    T, B = 7, 3
    rng = np.random.default_rng(H)
    xg = torch.tensor(rng.normal(size=(T, B, 4 * H)).astype(np.float32),
                      requires_grad=True)
    R, h0, c0 = (torch.tensor(a[k]) for k in ("R", "h0", "c0"))
    c0.requires_grad_()
    p = None if a["p"] is None else torch.tensor(a["p"])
    g_out, g_h, g_c = (torch.tensor(rng.normal(size=s).astype(np.float32))
                       for s in ((T, B, H), (B, H), (B, H)))
    out, hT, cT = plain_recurrence(xg, R, h0, c0, p)
    loss = (out * g_out).sum() + (hT * g_h).sum() + (cT * g_c).sum()
    dxg, dc0 = torch.autograd.grad(loss, (xg, c0))
    with torch.no_grad():
        _, _, _, reserve = plain_recurrence(xg, R, h0, c0, p,
                                            save_residuals=True)
    dout = g_out.clone()
    dout[-1] += g_h
    dg, dc0_plain = plain_bwd_recurrence(reserve, R, c0.detach(), dout, g_c, p)
    assert reserve.shape == (5, T, B, H) and dg.shape == (T, B, 4 * H)
    torch.testing.assert_close(dg, dxg, **TOL)
    torch.testing.assert_close(dc0_plain, dc0, **TOL)


def test_reserve_only_when_autograd_needs_it(monkeypatch):
    """Serving under torch.no_grad (or with nothing requiring grad) saves
    no reserve; a call autograd will differentiate saves it."""
    seen = []
    real = port_fused.plain_recurrence

    def spy(*args):
        seen.append(args[5])
        return real(*args)

    monkeypatch.setattr(port_fused, "plain_recurrence", spy)
    a = _inputs(8, seed=2)
    t = {k: torch.tensor(v) for k, v in a.items() if v is not None}
    args = [t[k] for k in NAMES[:6]]
    with torch.no_grad():
        fused_lstm_layer(*args, peephole=t["p"])
    fused_lstm_layer(*args, peephole=t["p"])
    W = t["W"].clone().requires_grad_()
    with torch.no_grad():
        fused_lstm_layer(*args[:3], W, *args[4:], peephole=t["p"])
    out, _ = fused_lstm_layer(*args[:3], W, *args[4:], peephole=t["p"])
    assert seen == [False, False, False, True]
    assert out.requires_grad


def test_empty_sequence_passes_carry_through():
    x = torch.zeros(2, 0, 3)
    h0 = torch.ones(2, 4, requires_grad=True)
    out, (h, c) = fused_lstm_layer(x, h0, torch.zeros(2, 4), torch.zeros(3, 16),
                                   torch.zeros(4, 16), torch.zeros(16))
    assert out.shape == (2, 0, 4)
    (g,) = torch.autograd.grad(h.sum(), h0)
    assert torch.equal(g, torch.ones(2, 4))


# --------------------------------------------------------------- on the card

def _card_case(device, g, B, T, H, peep, dtype):
    rnd = lambda *s, k=1.0: (torch.randn(*s, device=device, generator=g)
                             * k).to(dtype)
    xg, R = rnd(T, B, 4 * H), rnd(H, 4 * H, k=0.06)
    h0, c0 = rnd(B, H, k=0.5), rnd(B, H, k=0.5)
    p = rnd(3 * H, k=0.1) if peep else None
    dout, dcT = rnd(T, B, H), rnd(B, H)
    return xg, R, h0, c0, p, dout, dcT


@pytest.mark.cuda
def test_bwd_kernel_against_plain_on_card(cuda_device):
    """On the card: the forward's reserve and the backward kernel against
    their plain versions, at the training shapes and odd ones (rows past B
    in the last block, a partial unit tile, H large enough to shrink row
    groups). f32 tolerance 1e-4 abs (summation order); bf16 |a - b| <=
    1e-2 (1 + |b|), as the forward's bf16 check."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    for B, T, H, peep, dt in ((64, 64, 200, True, f32),
                              (64, 64, 256, False, f32),
                              (13, 3, 33, True, f32), (3, 5, 12, False, f32),
                              (9, 2, 1000, True, f32), (1, 1, 7, True, f32),
                              (64, 64, 200, True, bf16),
                              (13, 3, 33, True, bf16)):
        xg, R, h0, c0, p, dout, dcT = _card_case(cuda_device, g, B, T, H,
                                                 peep, dt)
        before = (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches)
        out, hT, cT, reserve = fused_lstm_recurrence(xg, R, h0, c0, p,
                                                     save_residuals=True)
        dg, dc0 = fused_lstm_bwd_recurrence(reserve, R, c0, dout, dcT, p)
        torch.cuda.synchronize()
        assert (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches) == (
            before[0] + 1, before[1] + 1)
        _, _, _, plain_res = plain_recurrence(xg, R, h0, c0, p,
                                              save_residuals=True)
        # the backward is held on the kernel's own reserve, so that its
        # check does not carry the forward's rounding differences
        pg, pc = plain_bwd_recurrence(reserve, R, c0, dout, dcT, p)
        for got, want in ((reserve, plain_res), (dg, pg), (dc0, pc)):
            assert got.dtype == f32
            if dt == f32:
                torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
            else:
                assert bool(((got - want).abs()
                             <= 1e-2 * (1 + want.abs())).all())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_lstm_bwd_recurrence(reserve, R.half(), c0.half(), dout.half())


@pytest.mark.cuda
@pytest.mark.parametrize("peep,rev", [(True, True), (False, False)],
                         ids=["peep-rev", "nopeep-fwd"])
def test_cuda_lstm_layer_trains_through_both_kernels(cuda_device, peep, rev):
    """Regression test for a CUDA lstm_layer whose gradients never reached
    W, R, b or the peepholes: with inputs that require grad, the registry's
    kernel path launches the forward (with reserve) and the backward
    kernel, and gives the plain path's gradients on the card."""
    a = _inputs(200, B=16, T=12, F=77, peephole=peep, seed=5)
    kw = dict(forget_gate_bias=1.0, reverse=rev)
    op = get_op("lstm_layer")
    before = (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches)
    got = _torch_grads(op, a, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    env.disable_kernels = True
    try:
        want = _torch_grads(op, a, device=cuda_device, **kw)
    finally:
        env.reload()
    assert (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    for n, g in got.items():
        scale = max(1.0, float(want[n].abs().max()))
        torch.testing.assert_close(g, want[n], atol=1e-4 * scale, rtol=0,
                                   msg=n)
    ref = _torch_grads(lstm_layer, a, **kw)  # the CPU plain path
    for n, g in got.items():
        scale = max(1.0, float(ref[n].abs().max()))
        torch.testing.assert_close(g.cpu(), ref[n], atol=1e-4 * scale, rtol=0,
                                   msg=n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_on_the_cluster_forwards_reserve_on_card(cuda_device,
                                                             dtype):
    """The backward kernel reads the cluster forward's reserve unchanged:
    at the training shapes ([64, 64, 200] with peepholes, [64, 64, 256]
    without) the forward runs its cluster design, its reserve agrees with
    the plain forward's, and the backward on it with the plain backward on
    the same reserve. Tolerances as test_bwd_kernel_against_plain_on_card;
    bf16 one bf16 step, |a - b| <= 2^-7 (1 + |b|), on the reserve."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    for B, T, H, peep in ((64, 64, 200, True), (64, 64, 256, False)):
        design = port_fused.launcher_design(T, B, H, dt)
        assert design == port_fused.fwd_design(T, B, H, dt)
        assert design.kind == "cluster"
        xg, R, h0, c0, p, dout, dcT = _card_case(cuda_device, g, B, T, H,
                                                 peep, dt)
        _, _, _, reserve = fused_lstm_recurrence(xg, R, h0, c0, p,
                                                 save_residuals=True)
        dg, dc0 = fused_lstm_bwd_recurrence(reserve, R, c0, dout, dcT, p)
        torch.cuda.synchronize()
        _, _, _, plain_res = plain_recurrence(xg, R, h0, c0, p,
                                              save_residuals=True)
        pg, pc = plain_bwd_recurrence(reserve, R, c0, dout, dcT, p)
        if dt == torch.float32:
            for got, want in ((reserve, plain_res), (dg, pg), (dc0, pc)):
                torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        else:
            assert bool(((reserve - plain_res).abs()
                         <= 2 ** -7 * (1 + plain_res.abs())).all())
            for got, want in ((dg, pg), (dc0, pc)):
                assert bool(((got - want).abs()
                             <= 1e-2 * (1 + want.abs())).all())


@pytest.mark.cuda
def test_cuda_lstm_layer_grads_at_the_training_shape(cuda_device):
    """FusedLSTMFunction at config #3's training shape (B 64, T 64, H 200,
    peepholes, reversed), the forward on its cluster design: the seven
    gradients against autograd through the plain lowering on the card,
    1e-4 of max(1, max |plain|) (TOL_GRAD of chip_smoke.py)."""
    a = _inputs(200, B=64, T=64, F=77, peephole=True, seed=8)
    kw = dict(forget_gate_bias=1.0, reverse=True)
    assert port_fused.launcher_design(64, 64, 200,
                                      torch.float32).kind == "cluster"
    assert port_fused.launcher_bwd_design(64, 64, 200,
                                          torch.float32).kind == "cluster"
    op = get_op("lstm_layer")
    before = (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches)
    got = _torch_grads(op, a, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert (FUSED_LSTM.launches, FUSED_LSTM_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    env.disable_kernels = True
    try:
        want = _torch_grads(op, a, device=cuda_device, **kw)
    finally:
        env.reload()
    for n, g in got.items():
        scale = max(1.0, float(want[n].abs().max()))
        torch.testing.assert_close(g, want[n], atol=1e-4 * scale, rtol=0,
                                   msg=n)


def _bwd_on_card(device, g, B, T, H, peep, dt, with_dcT=True):
    """The forward's reserve at one shape, the backward kernel on it (one
    launch), and the plain backward on the same reserve."""
    xg, R, h0, c0, p, dout, dcT = _card_case(device, g, B, T, H, peep, dt)
    dcT = dcT if with_dcT else None
    _, _, _, reserve = fused_lstm_recurrence(xg, R, h0, c0, p,
                                             save_residuals=True)
    before = FUSED_LSTM_BWD.launches
    dg, dc0 = fused_lstm_bwd_recurrence(reserve, R, c0, dout, dcT, p)
    torch.cuda.synchronize()
    assert FUSED_LSTM_BWD.launches == before + 1
    want = plain_bwd_recurrence(reserve, R, c0, dout, dcT, p)
    return (reserve, R, c0, dout, dcT, p), (dg, dc0), want


def _assert_bwd_within(got, want, dt):
    """f32: 1e-4 abs (summation order); bf16: |a - b| <= 1e-2 (1 + |b|),
    chip_smoke.py's ``_within`` (dg enters the product rounded to bf16, and
    a carry summed in another order can tip a rounding)."""
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        if dt == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
        else:
            assert bool(((a - b).abs() <= 1e-2 * (1 + b.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_cluster_design_against_plain_on_card(cuda_device, dtype):
    """The backward's cluster design (R resident across a cluster, the
    carry reduce-scattered through distributed shared memory) against the
    plain backward on the kernel's own reserve: config #3's [64, 64, 200]
    with peepholes (its reversal is the projection's, outside the kernel),
    [64, 64, 256], a ragged [37, 5, 256] (the last cluster's rows past B),
    T = 2, and dcT and the peepholes null. The launcher's choice is held
    against its Python mirror ``bwd_design``."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(9)
    for B, T, H, peep, with_dcT in ((64, 64, 200, True, True),
                                    (64, 64, 256, False, True),
                                    (37, 5, 256, True, True),
                                    (8, 2, 96, True, True),
                                    (16, 9, 200, False, False)):
        design = port_fused.launcher_bwd_design(T, B, H, dt)
        assert design == port_fused.bwd_design(T, B, H, dt)
        assert design.kind == "cluster"
        _, got, want = _bwd_on_card(cuda_device, g, B, T, H, peep, dt,
                                    with_dcT)
        _assert_bwd_within(got, want, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_stream_design_against_plain_on_card(cuda_device, dtype):
    """T = 1, and T > 1 one unit past the width a cluster of 16 holds
    (H = 441 in f32, 513 in bf16), take the stream design, against the
    plain backward."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(10)
    past = 441 if dt == torch.float32 else 513
    for B, T, H, peep in ((8, 1, 256, False), (5, 6, past, True)):
        design = port_fused.launcher_bwd_design(T, B, H, dt)
        assert design == port_fused.bwd_design(T, B, H, dt)
        assert design.kind == "stream"
        _, got, want = _bwd_on_card(cuda_device, g, B, T, H, peep, dt)
        _assert_bwd_within(got, want, dt)


@pytest.mark.cuda
def test_bwd_cluster_design_is_the_same_run_to_run(cuda_device):
    """Each CTA sums its C partial carries in rank order, so dg and dc0 are
    bit for bit the same run to run."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    args, first, _ = _bwd_on_card(cuda_device, g, 64, 64, 200, True,
                                  torch.float32)
    for _ in range(3):
        again = fused_lstm_bwd_recurrence(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
