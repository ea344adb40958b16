"""The port's fused GRU (kernel wrappers and plain versions) against the JAX
package and torch autograd.

The plain versions of the two kernels (``gru_recurrence`` with its reserve,
``gru_bwd_recurrence``) are held against the JAX package's Pallas kernels
in interpret mode (``_fused_gru_recurrence``, ``_bwd_recurrence``): the
outputs, hT, all four reserve planes, ga_r, ga_z, ga_n and dh0. On the CPU
the port's ``fused_gru_layer`` runs ``FusedGRUFunction`` over both plain
versions, so its gradients come from the same assembly code (dx, dW, dR,
db, and dh0 from the walk) as on the card; they are held against
``jax.grad`` through the JAX package's Pallas ``fused_gru_layer`` and
through its scan ``gru_layer``. f32 tolerance: rtol = 1e-5 and atol =
1e-5 of max(1, max |ref|) (only the order of the sums differs; at H=200
the gradients reach 30, and the sums of 200 such terms round at about
1e-6 of that). Weights are drawn at scale 0.3 or more, so
that r stays away from 1 and a mix-up of ga_n and r * ga_n shows. The
``cuda`` tests hold both kernels, each design of each, against their plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas.fused_gru import (
    _bwd_recurrence as jax_bwd_recurrence,
    _fused_gru_recurrence as jax_recurrence,
    _project_gates as jax_project_gates,
    fused_gru_layer as jax_fused,
)
from deeplearning4j_tpu.ops.recurrent import gru_layer as jax_scan
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.ops.cuda import fused_gru as port_fused
from deeplearning4j_tpu_torch.ops.cuda.fused_gru import (
    FUSED_GRU, FUSED_GRU_BWD, _gru_requires, fused_gru_bwd_recurrence,
    fused_gru_layer, fused_gru_recurrence, plain_bwd_recurrence,
    plain_recurrence,
)
from deeplearning4j_tpu_torch.ops.recurrent import gru_layer, project_gates
from deeplearning4j_tpu_torch.ops.registry import get_op

TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ("x", "h0", "W", "R", "b")


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


def _inputs(H, *, B=4, T=6, F=8, seed=0):
    """Inputs of one layer and cotangents for (out, hT), as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(x=f(B, T, F), h0=f(B, H, scale=0.5), W=f(F, 3 * H, scale=0.3),
                R=f(H, 3 * H, scale=0.3), b=f(3 * H, scale=0.3),
                g_out=f(B, T, H), g_h=f(B, H))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(got, want, **kw):
    """The f32 tolerance: rtol 1e-5, atol 1e-5 of max(1, max |want|)."""
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())),
        **kw)


def _forward_pair(a, reverse, dtype=(jnp.float32, torch.float32)):
    """The JAX Pallas forward (interpret) and the port's plain version on
    the same gates: (jax (out, hT, planes), port (out, hT, reserve))."""
    jdt, tdt = dtype
    j = {k: jnp.asarray(a[k], jdt) for k in NAMES}
    t = {k: torch.tensor(a[k]).to(tdt) for k in NAMES}
    jxg = jax_project_gates(j["x"], j["W"], j["b"], reverse)
    jout = jax_recurrence(jxg, j["R"], j["h0"], interpret=True,
                          save_residuals=True)
    xg = project_gates(t["x"], t["W"], t["b"], reverse=reverse)
    np.testing.assert_allclose(xg.float().numpy(), _np(jxg), **TOL)
    return jout, plain_recurrence(xg, t["R"], t["h0"], save_residuals=True)


FWD_CASES = [pytest.param(H, T, rev, id=f"H{H}-T{T}-{'rev' if rev else 'fwd'}")
             for H in (128, 40) for T in (1, 6) for rev in (False, True)]


@pytest.mark.parametrize("H,T,rev", FWD_CASES)
def test_forward_matches_pallas_interpret(H, T, rev):
    """out, hT and the four reserve planes (r, z, n, raw hg_n) == the
    Pallas _gru_kernel in interpret mode, at H=128 and an unaligned H=40
    (the JAX call runs it unpadded here; the port never pads)."""
    a = _inputs(H, T=T, seed=H + T + rev)
    (jo, jh, planes), (po, ph, reserve) = _forward_pair(a, rev)
    assert reserve.shape == (4, T, 4, H) and reserve.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), _np(jo), **TOL)
    np.testing.assert_allclose(ph.numpy(), _np(jh), **TOL)
    for i, name in enumerate(("r", "z", "n", "hg_n")):
        np.testing.assert_allclose(reserve[i].numpy(), _np(planes[i]),
                                   err_msg=name, **TOL)
    # no reserve: the same outputs
    out, hT = plain_recurrence(project_gates(
        torch.tensor(a["x"]), torch.tensor(a["W"]), torch.tensor(a["b"]),
        reverse=rev), torch.tensor(a["R"]), torch.tensor(a["h0"]))
    assert torch.equal(out, po) and torch.equal(hT, ph)


@pytest.mark.parametrize("H,T,rev", [c for c in FWD_CASES
                                     if c.id.startswith(("H128-T6", "H40"))])
def test_bwd_recurrence_matches_pallas_interpret(H, T, rev):
    """ga_r, ga_z, ga_n and dh0 == the Pallas _gru_bwd_kernel in interpret
    mode (plan (B, H): one batch block, one hidden slice), on each side's
    own forward reserve and a cotangent joined at the last kernel step."""
    a = _inputs(H, T=T, seed=3 * H + T + rev)
    (jo, jh, planes), (po, ph, reserve) = _forward_pair(a, rev)
    dout = np.random.default_rng(H).normal(size=(T, 4, H)).astype(np.float32)
    hprev = jnp.concatenate([jnp.asarray(a["h0"])[None], jo[:-1]], 0)
    ga_r, ga_z, ga_n, dh0 = jax_bwd_recurrence(
        planes, jnp.asarray(a["R"]), hprev, jnp.asarray(dout), plan=(4, H),
        interpret=True)
    dg, pdh0 = plain_bwd_recurrence(reserve, torch.tensor(a["R"]),
                                    torch.tensor(a["h0"]), po,
                                    torch.tensor(dout))
    assert dg.shape == (T, 4, 3 * H) and dg.dtype == torch.float32
    for i, (name, want) in enumerate((("ga_r", ga_r), ("ga_z", ga_z),
                                      ("ga_n", ga_n))):
        np.testing.assert_allclose(dg[..., i * H:(i + 1) * H].numpy(),
                                   _np(want), err_msg=name, **TOL)
    np.testing.assert_allclose(pdh0.numpy(), _np(dh0), **TOL)


def _jax_grads(fn, a, dtype=jnp.float32, **kw):
    cot = [jnp.asarray(a[k], dtype) for k in ("g_out", "g_h")]

    def loss(*args):
        out, h = fn(*args, **kw)
        return sum((v.astype(jnp.float32) * g.astype(jnp.float32)).sum()
                   for v, g in zip((out, h), cot))

    args = [jnp.asarray(a[n], dtype) for n in NAMES]
    grads = jax.grad(loss, argnums=tuple(range(5)))(*args)
    return {n: _np(g) for n, g in zip(NAMES, grads)}


def _torch_grads(fn, a, dtype=torch.float32, device="cpu", **kw):
    args = {n: torch.tensor(a[n], device=device).to(dtype).requires_grad_()
            for n in NAMES}
    out, h = fn(*(args[n] for n in NAMES), **kw)
    loss = sum((v.float() * torch.tensor(a[g], device=device).to(dtype).float()
                ).sum() for v, g in zip((out, h), ("g_out", "g_h")))
    grads = torch.autograd.grad(loss, [args[n] for n in NAMES])
    return dict(zip(NAMES, grads))


@pytest.mark.parametrize("H,T,rev", [
    pytest.param(12, 6, False, id="H12-T6-fwd"),
    pytest.param(12, 6, True, id="H12-T6-rev"),
    pytest.param(40, 1, True, id="H40-T1-rev"),
    pytest.param(200, 5, False, id="H200-T5-fwd"),
    pytest.param(200, 5, True, id="H200-T5-rev"),
])
def test_layer_grads_match_jax(H, T, rev):
    """All five gradients, with a non-zero h0 and cotangents on out and hT:
    port (plain fwd/bwd through FusedGRUFunction) == JAX Pallas backward
    (interpret; it pads H to lanes) == JAX scan autodiff, 1e-5."""
    a = _inputs(H, T=T, seed=H + T + 7 * rev)
    port = _torch_grads(fused_gru_layer, a, reverse=rev)
    for ref in (_jax_grads(jax_fused, a, reverse=rev),
                _jax_grads(jax_scan, a, reverse=rev)):
        for n, g in port.items():
            _assert_close(g.numpy(), ref[n], err_msg=n)


@pytest.mark.parametrize("H,rev", [(128, False), (40, True)],
                         ids=["H128-fwd", "H40-rev"])
def test_bf16_matches_pallas_within_one_step(H, rev, record_property):
    """bf16: the port's plain versions round where the Pallas kernels do
    (h_{t-1} and the backward's product operands to bf16, the carries and
    gates f32, the results stored in bf16), so the outputs, hT and every
    gradient lie within one bf16 step of the largest value (2^-7 of max
    |ref| at most: a step is 2^-8 to 2^-7 of a value's size) of the Pallas
    path in interpret mode. The JAX scan keeps h in bf16 between steps and
    rounds elsewhere: the outputs of both lie at least as close to the
    Pallas path as the scan's do (each distance is recorded in the test's
    report properties)."""
    a = _inputs(H, seed=H + 31)
    kw = dict(reverse=rev)
    bf = jnp.bfloat16
    jo, jh = jax_fused(*(jnp.asarray(a[n], bf) for n in NAMES), **kw)
    po, ph = fused_gru_layer(*(torch.tensor(a[n]).bfloat16() for n in NAMES),
                             **kw)
    assert po.dtype == ph.dtype == torch.bfloat16
    so, _ = jax_scan(*(jnp.asarray(a[n], bf) for n in NAMES), **kw)
    port_err = float(np.abs(po.float().numpy() - _np(jo)).max())
    scan_err = float(np.abs(_np(so) - _np(jo)).max())
    record_property("bf16_out_port_vs_pallas", port_err)
    record_property("bf16_out_scan_vs_pallas", scan_err)
    assert port_err <= scan_err
    for got, want in ((po, jo), (ph, jh)):
        ref = _np(want)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=2 ** -7 * np.abs(ref).max())
    port = _torch_grads(fused_gru_layer, a, dtype=torch.bfloat16, **kw)
    ref = _jax_grads(jax_fused, a, dtype=bf, **kw)
    for n, g in port.items():
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), ref[n], rtol=0,
                                   atol=2 ** -7 * np.abs(ref[n]).max(),
                                   err_msg=n)


@pytest.mark.parametrize("H", [12, 33])
def test_bwd_recurrence_matches_autograd(H):
    """The backward kernel's plain version == torch autograd through the
    forward's plain version: dg is the gradient of xg, dh0 that of h0."""
    T, B = 7, 3
    rng = np.random.default_rng(H)
    f = lambda *s, k=1.0: torch.tensor((rng.normal(size=s) * k).astype(
        np.float32))
    xg = f(T, B, 3 * H).requires_grad_()
    R, h0 = f(H, 3 * H, k=0.4), f(B, H, k=0.5).requires_grad_()
    g_out, g_h = f(T, B, H), f(B, H)
    out, hT = plain_recurrence(xg, R, h0)
    loss = (out * g_out).sum() + (hT * g_h).sum()
    dxg, dh0 = torch.autograd.grad(loss, (xg, h0))
    with torch.no_grad():
        out, _, reserve = plain_recurrence(xg, R, h0, save_residuals=True)
    dout = g_out.clone()
    dout[-1] += g_h
    dg, dh0_plain = plain_bwd_recurrence(reserve, R, h0.detach(), out, dout)
    torch.testing.assert_close(dg, dxg, **TOL)
    torch.testing.assert_close(dh0_plain, dh0, **TOL)


def test_reserve_only_when_autograd_needs_it(monkeypatch):
    """Serving under torch.no_grad (or with nothing requiring grad) saves
    no reserve; a call autograd will differentiate saves it."""
    seen = []
    real = port_fused.plain_recurrence

    def spy(*args):
        seen.append(args[3])
        return real(*args)

    monkeypatch.setattr(port_fused, "plain_recurrence", spy)
    a = _inputs(8, seed=2)
    args = [torch.tensor(a[k]) for k in NAMES]
    with torch.no_grad():
        fused_gru_layer(*args)
    fused_gru_layer(*args)
    W = args[2].clone().requires_grad_()
    with torch.no_grad():
        fused_gru_layer(*args[:2], W, *args[3:])
    out, _ = fused_gru_layer(*args[:2], W, *args[3:])
    assert seen == [False, False, False, True]
    assert out.requires_grad


def test_empty_sequence_passes_carry_through():
    x = torch.zeros(2, 0, 3)
    h0 = torch.ones(2, 4, requires_grad=True)
    out, h = fused_gru_layer(x, h0, torch.zeros(3, 12), torch.zeros(4, 12),
                             torch.zeros(12))
    assert out.shape == (2, 0, 4)
    (g,) = torch.autograd.grad(h.sum(), h0)
    assert torch.equal(g, torch.ones(2, 4))


def test_registry_sends_cpu_calls_to_plain_and_cuda_calls_to_the_kernel():
    """CPU tensors take the plain lowering; the kernel's ``requires`` asks
    that every tensor lies on the card and that the kernels can compute
    the call (f32 or bf16, H under their shared-memory limit; the choice
    at the limits is in test_torch_kernel_requires.py). No TPU predicate:
    any B reaches the wrapper, which launches or raises."""
    op = get_op("gru_layer")
    assert [i.platform for i in op.impls] == ["plain", "cuda"]
    a = _inputs(5, seed=4)
    args = [torch.tensor(a[k]) for k in NAMES]
    assert op.select(*args).fn is gru_layer
    assert not _gru_requires(*args)

    class OnCard(torch.Tensor):
        is_cuda = property(lambda self: True)

    fake = [torch.empty(t.shape, device="meta").as_subclass(OnCard)
            for t in args]
    assert _gru_requires(*fake)
    assert get_op("simple_rnn_layer").impls[0].platform == "plain"


def test_wrappers_refuse_other_devices():
    xg = torch.zeros(1, 1, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gru_recurrence(xg, xg, xg)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_gru_bwd_recurrence(xg, xg, xg, xg, xg)


# --------------------------------------------------------------- on the card

def _card_case(device, g, B, T, H, dtype):
    rnd = lambda *s, k=1.0: (torch.randn(*s, device=device, generator=g)
                             * k).to(dtype)
    return (rnd(T, B, 3 * H), rnd(H, 3 * H, k=1.0 / H ** 0.5),
            rnd(B, H, k=0.5), rnd(T, B, H))


@pytest.mark.cuda
def test_kernels_against_plain_on_card(cuda_device):
    """On the card: the forward kernel (with and without the reserve) and
    the backward kernel against their plain versions, at the main path's
    shapes and odd ones (rows past B in the last block, a partial unit
    tile, H=1024 with shrunken row groups, decode split over unit tiles).
    f32 tolerance 1e-5 of max |plain| (summation order); bf16 one bf16
    step, |a - b| <= 2^-7 (1 + |b|) (a value rounded to its neighbour)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    for B, T, H, dt in ((8, 1, 256, f32), (1, 47, 256, f32),
                        (64, 64, 256, f32), (64, 8, 1024, f32),
                        (3, 5, 200, f32), (13, 3, 33, f32), (1, 1, 7, f32),
                        (8, 1, 256, bf16), (64, 64, 256, bf16),
                        (3, 5, 200, bf16)):
        xg, R, h0, dout = _card_case(cuda_device, g, B, T, H, dt)
        before = (FUSED_GRU.launches, FUSED_GRU_BWD.launches)
        out, hT = fused_gru_recurrence(xg, R, h0)
        out_r, hT_r, reserve = fused_gru_recurrence(xg, R, h0,
                                                    save_residuals=True)
        dg, dh0 = fused_gru_bwd_recurrence(reserve, R, h0, out_r, dout)
        torch.cuda.synchronize()
        assert (FUSED_GRU.launches, FUSED_GRU_BWD.launches) == (
            before[0] + 2, before[1] + 1)
        assert torch.equal(out, out_r) and torch.equal(hT, hT_r)
        assert torch.equal(hT, out[-1])
        po, ph, pres = plain_recurrence(xg, R, h0, save_residuals=True)
        # the backward is held on the kernel's own reserve and outputs, so
        # that its check does not carry the forward's rounding differences
        pdg, pdh0 = plain_bwd_recurrence(reserve, R, h0, out_r, dout)
        for got, want in ((out, po), (hT, ph), (reserve, pres), (dg, pdg),
                          (dh0, pdh0)):
            got, want = got.float(), want.float()
            if dt == f32:
                tol = 1e-5 * max(1.0, float(want.abs().max()))
                torch.testing.assert_close(got, want, atol=tol, rtol=0)
            else:
                assert bool(((got - want).abs()
                             <= 2 ** -7 * (1 + want.abs())).all())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_gru_recurrence(xg.half(), R.half(), h0.half())


def _ran(fn, kind, calls=3):
    """Run ``fn`` (one forward launch) ``calls`` times under the profiler,
    after a warm-up call outside it: (did every call launch the ``kind``
    design and none of the others, the event counts). The cluster and grid
    designs launch through cudaLaunchKernelEx (for the cluster dimension,
    or the cooperative attribute), the stream design through
    cudaLaunchKernel; these host calls are always recorded. The kernels'
    device records are not: on the H100 a short window kept 0 to 2 of 3,
    so they are checked only for the other designs' kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    ex = sum(n for k, n in counts.items()
             if k.startswith("cudaLaunchKernelEx"))
    plain = counts.get("cudaLaunchKernel", 0)
    # a name that holds "gru_fwd_kernel" is never the cluster or grid
    # kernel's
    other_ran = any(name in k for other, name in
                    port_fused.FWD_KERNEL_NAMES.items() if other != kind
                    for k in counts)
    launched = (ex, plain) == ((0, calls) if kind == "stream"
                               else (calls, 0))
    return launched and not other_ran, counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [200, 256])
def test_cluster_kernel_against_plain_on_card(cuda_device, H, dtype):
    """The cluster design (R resident across a thread-block cluster) at
    H 200 and 256, B 1, 3 and 64, T 2 and 64, both directions: out, hT and
    the reserve against the plain version, out bit-equal with and without
    the reserve, the backward kernel on its reserve against the plain
    backward; the launcher's choice is fwd_design's and every call
    launches the cluster design. Tolerances as
    test_kernels_against_plain_on_card."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(H)
    for B in (1, 3, 64):
        for T in (2, 64):
            for rev in (False, True):
                design = port_fused.launcher_design(T, B, H, dt)
                assert design == port_fused.fwd_design(T, B, H, dt)
                assert design.kind == "cluster"
                x = torch.randn(B, T, 77, device=cuda_device,
                                generator=g).to(dt)
                W = (torch.randn(77, 3 * H, device=cuda_device, generator=g)
                     * 77 ** -0.5).to(dt)
                b = (0.1 * torch.randn(3 * H, device=cuda_device,
                                       generator=g)).to(dt)
                _, R, h0, dout = _card_case(cuda_device, g, B, T, H, dt)
                xg = project_gates(x, W, b, reverse=rev)
                ok, counts = _ran(lambda: fused_gru_recurrence(xg, R, h0),
                                  "cluster")
                assert ok, (B, T, rev, counts)
                out, hT = fused_gru_recurrence(xg, R, h0)
                out_r, hT_r, res = fused_gru_recurrence(
                    xg, R, h0, save_residuals=True)
                dg, dh0 = fused_gru_bwd_recurrence(res, R, h0, out_r, dout)
                torch.cuda.synchronize()
                assert torch.equal(out, out_r) and torch.equal(hT, hT_r)
                po, ph, pres = plain_recurrence(xg, R, h0,
                                                save_residuals=True)
                pdg, pdh0 = plain_bwd_recurrence(res, R, h0, out_r, dout)
                for got, want in ((out, po), (hT, ph), (res, pres),
                                  (dg, pdg), (dh0, pdh0)):
                    got, want = got.float(), want.float()
                    if dt == torch.float32:
                        tol = 1e-5 * max(1.0, float(want.abs().max()))
                        torch.testing.assert_close(got, want, atol=tol,
                                                   rtol=0)
                    else:
                        assert bool(((got - want).abs()
                                     <= 2 ** -7 * (1 + want.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,kind", [(512, "cluster"), (514, "grid")])
def test_design_boundary_on_card(cuda_device, H, kind, dtype):
    """Both sides of the design boundary: H=512 takes clusters of 16 CTAs,
    32 units each; H=514 the grid design (R across the card). Either
    against the plain version (T 2, B 3)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    design = port_fused.launcher_design(2, 3, H, dt)
    assert design == port_fused.fwd_design(2, 3, H, dt)
    assert design.kind == kind
    assert design.cluster == (16 if kind == "cluster" else None)
    xg, R, h0, _ = _card_case(cuda_device, g, 3, 2, H, dt)
    ok, counts = _ran(lambda: fused_gru_recurrence(xg, R, h0), kind)
    assert ok, counts
    out, hT, res = fused_gru_recurrence(xg, R, h0, save_residuals=True)
    torch.cuda.synchronize()
    po, ph, pres = plain_recurrence(xg, R, h0, save_residuals=True)
    for got, want in ((out, po), (hT, ph), (res, pres)):
        got, want = got.float(), want.float()
        if dt == torch.float32:
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, atol=tol, rtol=0)
        else:
            assert bool(((got - want).abs()
                         <= 2 ** -7 * (1 + want.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,dtype,kind", [
    (1, 8, 256, "float32", "stream"), (1, 8, 1024, "float32", "stream"),
    (64, 64, 1024, "float32", "grid"), (64, 64, 1024, "bfloat16", "grid"),
    (64, 64, 768, "float32", "grid"), (5, 3, 640, "float32", "grid"),
    (47, 1, 256, "float32", "cluster"), (64, 64, 256, "bfloat16", "cluster"),
    (64, 64, 200, "float32", "cluster"), (8, 64, 1200, "float32", "stream"),
    (8, 64, 1200, "bfloat16", "stream")])
def test_decode_and_wide_r_take_the_stream_design_on_card(cuda_device, T, B,
                                                          H, dtype, kind):
    """Decode (T == 1) runs the stream kernel at any width, T > 1 the
    cluster kernel to H = 512, the grid kernel past it, and the stream
    kernel again past the width the grid holds (H = 1200); the forward and
    backward launchers' choices are fwd_design's and bwd_design's at the
    GRU paths' shapes."""
    dt = getattr(torch, dtype)
    for launcher, mirror in ((port_fused.launcher_design,
                              port_fused.fwd_design),
                             (port_fused.launcher_bwd_design,
                              port_fused.bwd_design)):
        design = launcher(T, B, H, dt)
        assert design == mirror(T, B, H, dt)
        assert design.kind == kind, (T, B, H, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True], ids=["fwd", "rev"])
def test_cuda_gru_layer_trains_through_both_kernels(cuda_device, rev):
    """With inputs that require grad, the registry's kernel path launches
    the forward (with reserve) and the backward kernel, and gives the plain
    path's gradients on the card and on the CPU."""
    a = _inputs(200, B=16, T=12, F=77, seed=5)
    op = get_op("gru_layer")
    before = (FUSED_GRU.launches, FUSED_GRU_BWD.launches, FUSED_GRU.reserves)
    got = _torch_grads(op, a, device=cuda_device, reverse=rev)
    torch.cuda.synchronize()
    assert (FUSED_GRU.launches, FUSED_GRU_BWD.launches,
            FUSED_GRU.reserves) == (before[0] + 1, before[1] + 1,
                                    before[2] + 1)
    env.disable_kernels = True
    try:
        want = _torch_grads(op, a, device=cuda_device, reverse=rev)
    finally:
        env.reload()
    assert FUSED_GRU.launches == before[0] + 1
    ref = _torch_grads(gru_layer, a, reverse=rev)  # the CPU plain path
    for n, g in got.items():
        for w in (want[n], ref[n]):
            scale = max(1.0, float(w.abs().max()))
            torch.testing.assert_close(g.cpu(), w.cpu(), atol=1e-5 * scale,
                                       rtol=0, msg=n)


def _cluster_launches(fn, calls=3):
    """How many of ``calls`` calls of ``fn`` (one backward launch each,
    after a warm-up outside the profiler) went through cudaLaunchKernelEx:
    the cluster design launches that way (for its cluster dimension), the
    stream design and R^T's transpose through cudaLaunchKernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunchKernelEx"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_cluster_kernel_against_plain_on_card(cuda_device, dtype):
    """The backward's cluster design (R resident across a cluster, the
    partial carries reduce-scattered through distributed shared memory) at
    the GRU paths' training shapes, [64, 64, 256] and Bidirectional
    GRU(200)'s reversed [64, 64, 200], and a ragged reversed [3, 5, 200];
    the stream design (R^T from L2) at T = 1 and past the width the grid
    holds (H = 1200), and the grid design at H = 1024. The launcher's
    choice is bwd_design's, and the cluster and grid designs alone launch
    through cudaLaunchKernelEx. dg and dh0 against the plain backward on
    the kernel's own reserve, and bit-equal from run to run (each carry
    sums its slots in rank order). Tolerances as
    test_kernels_against_plain_on_card."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    for B, T, H, rev, kind in ((64, 64, 256, False, "cluster"),
                               (64, 64, 200, True, "cluster"),
                               (3, 5, 200, True, "cluster"),
                               (8, 1, 256, False, "stream"),
                               (64, 8, 1200, False, "stream"),
                               (64, 8, 1024, False, "grid")):
        design = port_fused.launcher_bwd_design(T, B, H, dt)
        assert design == port_fused.bwd_design(T, B, H, dt)
        assert design.kind == kind, (B, T, H)
        x = torch.randn(B, T, 77, device=cuda_device, generator=g).to(dt)
        W = (torch.randn(77, 3 * H, device=cuda_device, generator=g)
             * 77 ** -0.5).to(dt)
        b = (0.1 * torch.randn(3 * H, device=cuda_device,
                               generator=g)).to(dt)
        _, R, h0, dout = _card_case(cuda_device, g, B, T, H, dt)
        xg = project_gates(x, W, b, reverse=rev)
        out, _, res = fused_gru_recurrence(xg, R, h0, save_residuals=True)

        def bwd():
            return fused_gru_bwd_recurrence(res, R, h0, out, dout)

        assert _cluster_launches(bwd) == (0 if kind == "stream" else 3)
        before = FUSED_GRU_BWD.launches
        (dg, dh0), (dg2, dh02) = bwd(), bwd()
        torch.cuda.synchronize()
        assert FUSED_GRU_BWD.launches == before + 2
        assert torch.equal(dg, dg2) and torch.equal(dh0, dh02)
        pdg, pdh0 = plain_bwd_recurrence(res, R, h0, out, dout)
        for got, want in ((dg, pdg), (dh0, pdh0)):
            assert got.dtype == torch.float32
            if dt == torch.float32:
                tol = 1e-5 * max(1.0, float(want.abs().max()))
                torch.testing.assert_close(got, want, atol=tol, rtol=0)
            else:
                assert bool(((got - want).abs()
                             <= 2 ** -7 * (1 + want.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True], ids=["fwd", "rev"])
def test_cuda_gru_layer_grads_at_the_training_shape(cuda_device, rev):
    """FusedGRUFunction at the GRU char-RNN's training shape (B 64, T 64,
    H 256), both kernels on their cluster designs: the five gradients
    against autograd through the plain lowering on the card, 1e-4 of
    max(1, max |plain|) (TOL_GRAD of chip_smoke.py: dW and db are sums of
    4096 terms, taken in other orders). The weights are drawn as a layer
    is initialised (W and R at 1 / sqrt(fan-in)): _inputs' scale 0.3 at
    H 256 makes the recurrence chaotic over 64 steps, where any two
    summation orders part."""
    a = _inputs(256, B=64, T=64, F=77, seed=9)
    a["W"] *= 77 ** -0.5 / 0.3
    a["R"] *= 256 ** -0.5 / 0.3
    for launcher, mirror in ((port_fused.launcher_design,
                              port_fused.fwd_design),
                             (port_fused.launcher_bwd_design,
                              port_fused.bwd_design)):
        d = launcher(64, 64, 256, torch.float32)
        assert d == mirror(64, 64, 256, torch.float32)
        assert d.kind == "cluster"
    op = get_op("gru_layer")
    before = (FUSED_GRU.launches, FUSED_GRU_BWD.launches)
    got = _torch_grads(op, a, device=cuda_device, reverse=rev)
    torch.cuda.synchronize()
    assert (FUSED_GRU.launches, FUSED_GRU_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    env.disable_kernels = True
    try:
        want = _torch_grads(op, a, device=cuda_device, reverse=rev)
    finally:
        env.reload()
    for n, g in got.items():
        scale = max(1.0, float(want[n].abs().max()))
        torch.testing.assert_close(g, want[n], atol=1e-4 * scale, rtol=0,
                                   msg=lambda m, n=n: f"{n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,rev", [
    (64, 64, 1024, False), (3, 5, 640, True), (8, 16, 1000, False),
    (64, 64, 768, False)], ids=["h1024", "h640_rev", "h1000", "h768"])
def test_grid_kernels_against_plain_on_card(cuda_device, B, T, H, rev,
                                            dtype):
    """The grid design (R across the card, one barrier a step over a row
    group, h and the partial carries through L2; the bf16 step products on
    the tensor cores) at widths no cluster holds, ragged ones too (H 1000
    and 640 not a multiple of a CTA's units, B = 3 under a group's 8 rows,
    reversed): out, hT and the four
    reserve planes against the plain forward, out bit-equal with and
    without the reserve; dg and dh0 against the plain backward on the
    kernel's own reserve, bit-equal from run to run. Both launchers' plans
    are their mirrors' and run gru_fwd_grid_kernel and gru_bwd_grid_kernel
    alone. Tolerances as test_kernels_against_plain_on_card."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(H + B)
    for launcher, mirror in ((port_fused.launcher_design,
                              port_fused.fwd_design),
                             (port_fused.launcher_bwd_design,
                              port_fused.bwd_design)):
        d = launcher(T, B, H, dt)
        assert d == mirror(T, B, H, dt)
        assert d.kind == "grid", d
    x = torch.randn(B, T, 77, device=cuda_device, generator=g).to(dt)
    W = (torch.randn(77, 3 * H, device=cuda_device, generator=g)
         * 77 ** -0.5).to(dt)
    b = (0.1 * torch.randn(3 * H, device=cuda_device, generator=g)).to(dt)
    _, R, h0, dout = _card_case(cuda_device, g, B, T, H, dt)
    xg = project_gates(x, W, b, reverse=rev)
    ok, counts = _ran(lambda: fused_gru_recurrence(xg, R, h0), "grid")
    assert ok, counts
    out, hT = fused_gru_recurrence(xg, R, h0)
    out_r, hT_r, res = fused_gru_recurrence(xg, R, h0, save_residuals=True)

    def bwd():
        return fused_gru_bwd_recurrence(res, R, h0, out_r, dout)

    assert _cluster_launches(bwd) == 3
    (dg, dh0), (dg2, dh02) = bwd(), bwd()
    torch.cuda.synchronize()
    assert torch.equal(out, out_r) and torch.equal(hT, hT_r)
    assert torch.equal(hT, out[-1])
    assert torch.equal(dg, dg2) and torch.equal(dh0, dh02)
    po, ph, pres = plain_recurrence(xg, R, h0, save_residuals=True)
    pdg, pdh0 = plain_bwd_recurrence(res, R, h0, out_r, dout)
    for name, got, want in (("out", out, po), ("hT", hT, ph),
                            ("reserve", res, pres), ("dg", dg, pdg),
                            ("dh0", dh0, pdh0)):
        got, want = got.float(), want.float()
        if dt == torch.float32:
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, atol=tol, rtol=0,
                                       msg=lambda m, n=name: f"{n}: {m}")
        else:
            assert bool(((got - want).abs()
                         <= 2 ** -7 * (1 + want.abs())).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True], ids=["fwd", "rev"])
def test_cuda_gru_layer_grads_on_the_grid_design(cuda_device, rev):
    """FusedGRUFunction at [B 8, T 16, H 640], both kernels on their grid
    designs: the five gradients against autograd through the plain
    lowering on the card, 1e-4 of max(1, max |plain|) (as
    test_cuda_gru_layer_grads_at_the_training_shape); weights drawn as a
    layer is initialised."""
    H = 640
    a = _inputs(H, B=8, T=16, F=77, seed=13)
    a["W"] *= 77 ** -0.5 / 0.3
    a["R"] *= H ** -0.5 / 0.3
    for launcher, mirror in ((port_fused.launcher_design,
                              port_fused.fwd_design),
                             (port_fused.launcher_bwd_design,
                              port_fused.bwd_design)):
        d = launcher(16, 8, H, torch.float32)
        assert d == mirror(16, 8, H, torch.float32)
        assert d.kind == "grid"
    op = get_op("gru_layer")
    before = (FUSED_GRU.launches, FUSED_GRU_BWD.launches)
    got = _torch_grads(op, a, device=cuda_device, reverse=rev)
    torch.cuda.synchronize()
    assert (FUSED_GRU.launches, FUSED_GRU_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    env.disable_kernels = True
    try:
        want = _torch_grads(op, a, device=cuda_device, reverse=rev)
    finally:
        env.reload()
    assert set(got) == set(NAMES)
    for n, g in got.items():
        scale = max(1.0, float(want[n].abs().max()))
        torch.testing.assert_close(g, want[n], atol=1e-4 * scale, rtol=0,
                                   msg=lambda m, n=n: f"{n}: {m}")
