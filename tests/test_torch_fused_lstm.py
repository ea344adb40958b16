"""Port's lstm_layer and fused-LSTM kernel wrapper against the JAX package.

The same numpy inputs go through the JAX package's Pallas kernel
(``fused_lstm_layer``, interpret mode off-TPU, as tests/test_pallas_kernels.py
runs it), its scan lowering (``ops.recurrent.lstm_layer``), and the port's
plain lowering and kernel wrapper (which takes the plain version for CPU
tensors). Tolerance atol = rtol = 1e-5 in f32: only the order of the matmul
sums differs. In bf16 the port's plain version follows the Pallas kernel's
numerics (f32 sums and cell state, h rounded to bf16 for the product) and
is held against it within one bf16 rounding step, 2^-7. The kernel itself
runs only on the card: the ``cuda`` tests below hold it against the plain
version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.pallas.fused_lstm import fused_lstm_layer as jax_fused
from deeplearning4j_tpu.ops.recurrent import lstm_layer as jax_scan
from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.ops.cuda import fused_lstm as port_lstm
from deeplearning4j_tpu_torch.ops.cuda.fused_lstm import (
    FUSED_LSTM, fused_lstm_layer, fused_lstm_recurrence, plain_recurrence,
)
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.ops.recurrent import lstm_layer, project_gates
from deeplearning4j_tpu_torch.ops.registry import OpImpl, _Op, get_op

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2 ** -7, rtol=2 ** -7)


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
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(x=f(B, T, F), h0=f(B, H, scale=0.5), c0=f(B, H, scale=0.5),
                W=f(F, 4 * H, scale=0.3), R=f(H, 4 * H, scale=0.1),
                b=f(4 * H, scale=0.1),
                p=f(3 * H, scale=0.2) if peephole else None)


def _run_jax(fn, a, **kw):
    args = [jnp.asarray(a[k]) for k in ("x", "h0", "c0", "W", "R", "b")]
    p = None if a["p"] is None else jnp.asarray(a["p"])
    out, (h, c) = fn(*args, peephole=p, **kw)
    return [np.asarray(v) for v in (out, h, c)]


def _run_torch(fn, a, **kw):
    args = [torch.as_tensor(a[k]) for k in ("x", "h0", "c0", "W", "R", "b")]
    p = None if a["p"] is None else torch.as_tensor(a["p"])
    out, (h, c) = fn(*args, peephole=p, **kw)
    return [v.numpy() for v in (out, h, c)]


CASES = [
    pytest.param(H, peep, rev, fgb, id=f"H{H}-{'peep' if peep else 'nopeep'}"
                 f"-{'rev' if rev else 'fwd'}-fgb{fgb}")
    for H in (12, 200)
    for peep, rev, fgb in ((False, False, 0.0), (True, False, 1.0),
                           (False, True, 1.0), (True, True, 0.5))
]


@pytest.mark.parametrize("H,peep,rev,fgb", CASES)
def test_lstm_layer_matches_jax(H, peep, rev, fgb):
    """Port plain lowering == JAX Pallas (interpret) == JAX scan, 1e-5."""
    a = _inputs(H, peephole=peep, seed=H)
    kw = dict(forget_gate_bias=fgb, reverse=rev)
    port = _run_torch(lstm_layer, a, **kw)
    for ref in (_run_jax(jax_fused, a, **kw), _run_jax(jax_scan, a, **kw)):
        for got, want in zip(port, ref):
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("H,peep,rev", [(12, True, True), (200, False, False)],
                         ids=["H12-peep-rev", "H200-nopeep-fwd"])
def test_lstm_layer_bf16_matches_jax_pallas(H, peep, rev):
    """bf16: port plain lowering == JAX Pallas kernel (interpret), whose
    numerics the port's kernel and plain version share."""
    a = _inputs(H, peephole=peep, seed=H + 1)
    kw = dict(forget_gate_bias=1.0, reverse=rev)
    ja = {k: None if v is None else jnp.asarray(v, jnp.bfloat16)
          for k, v in a.items()}
    args = [ja[k] for k in ("x", "h0", "c0", "W", "R", "b")]
    out, (h, c) = jax_fused(*args, peephole=ja["p"], **kw)
    want = [np.asarray(v.astype(jnp.float32)) for v in (out, h, c)]
    ta = {k: None if v is None else
          torch.as_tensor(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
          for k, v in ja.items()}
    out, (h, c) = lstm_layer(*[ta[k] for k in ("x", "h0", "c0", "W", "R", "b")],
                             peephole=ta["p"], **kw)
    assert out.dtype == h.dtype == c.dtype == torch.bfloat16
    for got, w in zip((out, h, c), want):
        np.testing.assert_allclose(got.float().numpy(), w, **BF16_TOL)


def test_plain_recurrence_bf16_keeps_f32_state():
    """In bf16 the cell state is carried in f32 between steps: the result
    equals an f32 run with h rounded to bf16 before each product."""
    a = _inputs(16, B=3, T=6, F=4, seed=9)
    x, W, R, b, h0, c0, p = (torch.as_tensor(a[k]) for k in
                             ("x", "W", "R", "b", "h0", "c0", "p"))
    bf = lambda t: t.to(torch.bfloat16)
    xg = project_gates(bf(x), bf(W), bf(b))
    out, hT, cT = plain_recurrence(xg, bf(R), bf(h0), bf(c0), bf(p))
    H = 16
    h, c = bf(h0).float(), bf(c0).float()
    pf = bf(p).float()
    for t in range(6):
        g = xg[t].float() + bf(h).float() @ bf(R).float()
        i = torch.sigmoid(g[:, :H] + c * pf[:H])
        f = torch.sigmoid(g[:, H:2 * H] + c * pf[H:2 * H])
        c = f * c + i * torch.tanh(g[:, 3 * H:])
        h = torch.sigmoid(g[:, 2 * H:3 * H] + c * pf[2 * H:]) * torch.tanh(c)
        torch.testing.assert_close(out[t], bf(h), rtol=0, atol=0)
    torch.testing.assert_close(hT, bf(h), rtol=0, atol=0)
    torch.testing.assert_close(cT, bf(c), rtol=0, atol=0)


@pytest.mark.parametrize("H", [12, 200])
def test_kernel_wrapper_on_cpu_is_plain(H):
    """A CPU tensor takes the plain version, bit-for-bit, and launches
    nothing."""
    a = _inputs(H, seed=3)
    before = FUSED_LSTM.launches
    kw = dict(forget_gate_bias=1.0, reverse=True)
    for got, want in zip(_run_torch(fused_lstm_layer, a, **kw),
                         _run_torch(lstm_layer, a, **kw)):
        np.testing.assert_array_equal(got, want)
    assert FUSED_LSTM.launches == before


def test_recurrence_empty_sequence_returns_initial_carry():
    h0, c0 = torch.ones(2, 3), torch.full((2, 3), 2.0)
    out, h, c = fused_lstm_recurrence(torch.zeros(0, 2, 12), torch.zeros(3, 12),
                                      h0, c0)
    assert out.shape == (0, 2, 3)
    assert torch.equal(h, h0) and torch.equal(c, c0)


def test_project_gates_layout():
    """Time-major, reversed, forget-gate bias on the second quarter only."""
    a = _inputs(3, B=2, T=4, F=5, peephole=False)
    x, W, b = (torch.as_tensor(a[k]) for k in ("x", "W", "b"))
    xg = project_gates(x, W, b, forget_gate_bias=2.0, reverse=True)
    ref = (x @ W + b).transpose(0, 1).flip(0)
    ref[..., 3:6] += 2.0
    assert xg.shape == (4, 2, 12) and xg.is_contiguous()
    torch.testing.assert_close(xg, ref, rtol=0, atol=0)


class TestRegistry:
    def _args(self, dtype=torch.float32):
        B, T, F, H = 8, 1, 5, 16
        z = lambda *s: torch.zeros(*s, dtype=dtype)
        return (z(B, T, F), z(B, H), z(B, H), z(F, 4 * H), z(H, 4 * H),
                z(4 * H))

    def test_cpu_takes_plain(self):
        op = get_op("lstm_layer")
        assert op.select(*self._args()).platform == "plain"
        assert op.select(*self._args(), peephole=torch.zeros(48)).platform == "plain"

    def test_kernel_registered_without_tpu_threshold(self):
        impls = {i.platform: i for i in get_op("lstm_layer").impls}
        assert set(impls) == {"plain", "cuda"}
        assert impls["cuda"].predicate is None  # measured on the card later
        assert impls["cuda"].fn is fused_lstm_layer

    def test_choice_cached_per_signature(self):
        op = get_op("lstm_layer")
        op.select(*self._args())
        n = len(op._choices)
        op.select(*self._args())  # same device/dtype/shapes: cache hit
        assert len(op._choices) == n
        op.select(*self._args(torch.float64))
        assert len(op._choices) == n + 1

    def test_disable_flag_and_cpu_call(self, monkeypatch):
        monkeypatch.setattr(env, "disable_kernels", True)
        out, (h, c) = get_op("lstm_layer")(*self._args())
        assert out.shape == (8, 1, 16) and h.shape == (8, 16)

    @pytest.mark.parametrize("force,disable,want", [
        (False, False, "fallback"),  # "fast" fails its predicate
        (True, False, "fast"),       # force skips the predicate...
        (True, True, "plain"),       # ...and disable beats everything
    ], ids=["default", "force", "disable"])
    def test_predicate_priority_force(self, monkeypatch, force, disable, want):
        """Selection seam on a CUDA call (the device is faked: there is
        no card here): priority orders the kernels, the predicate can veto
        one, FORCE skips the predicate, ``requires`` is never skipped."""
        monkeypatch.setattr(registry, "_device_type", lambda a, k: "cuda")
        monkeypatch.setattr(env, "force_kernels", force)
        monkeypatch.setattr(env, "disable_kernels", disable)
        o = _Op("seam")
        o.impls = [
            OpImpl("seam", "plain", lambda x: "plain"),
            OpImpl("seam", "cuda", lambda x: "unfit", priority=9,
                   requires=lambda x: False),
            OpImpl("seam", "cuda", lambda x: "fast", priority=2,
                   predicate=lambda x: False),
            OpImpl("seam", "cuda", lambda x: "fallback", priority=1),
        ]
        assert o(torch.zeros(2)) == want


@pytest.mark.cuda
def test_kernel_against_plain_on_card(cuda_device):
    """On the card: the kernel at the main path's shapes, the GravesLSTM
    width and odd shapes, against its plain version (f32, tolerance 1e-4:
    summation order), and the registry picking it for CUDA tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for B, T, H, peep in ((8, 1, 256, False), (1, 47, 256, False),
                          (32, 64, 200, True), (3, 5, 12, True),
                          # odd batch and hidden sizes, a partial unit tile
                          # at T=1, and H large enough to shrink row groups
                          (13, 1, 200, True), (9, 2, 33, False),
                          (5, 3, 1000, True), (2, 1, 2048, False),
                          (3, 4, 2048, True)):
        rnd = lambda *s, k=1.0: torch.randn(*s, device=cuda_device,
                                            generator=g) * k
        xg, R = rnd(T, B, 4 * H), rnd(H, 4 * H, k=0.06)
        h0, c0 = rnd(B, H, k=0.5), rnd(B, H, k=0.5)
        p = rnd(3 * H, k=0.1) if peep else None
        before = FUSED_LSTM.launches
        got = fused_lstm_recurrence(xg, R, h0, c0, p)
        torch.cuda.synchronize()
        assert FUSED_LSTM.launches == before + 1
        for a, r in zip(got, plain_recurrence(xg, R, h0, c0, p)):
            torch.testing.assert_close(a, r, atol=1e-4, rtol=0)
    args = [torch.zeros(s, device=cuda_device) for s in
            ((8, 1, 5), (8, 16), (8, 16), (5, 64), (16, 64), (64,))]
    assert get_op("lstm_layer").select(*args).platform == "cuda"
    with pytest.raises(TypeError):
        fused_lstm_recurrence(xg.double(), R.double(), h0.double(),
                              c0.double())


@pytest.mark.cuda
def test_bf16_kernel_against_plain_on_card(cuda_device):
    """bf16 on the card: the registry sends the call to the kernel, which
    agrees with the plain version within one or two bf16 rounding steps
    (f32 sums in different orders may round a stored value to its
    neighbour, and the rounded h feeds later steps). A type the kernels
    have no code for (f16) goes to the plain lowering, and the wrapper
    raises if called with it; mixed f32/bf16 operands run the f32 kernel
    on the widened operands."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    bf16 = torch.bfloat16
    for B, T, H, peep in ((8, 1, 256, False), (1, 47, 256, False),
                          (32, 64, 200, True), (13, 3, 33, True)):
        rnd = lambda *s, k=1.0: (torch.randn(*s, device=cuda_device,
                                             generator=g) * k).to(bf16)
        xg, R = rnd(T, B, 4 * H), rnd(H, 4 * H, k=0.06)
        h0, c0 = rnd(B, H, k=0.5), rnd(B, H, k=0.5)
        p = rnd(3 * H, k=0.1) if peep else None
        before = FUSED_LSTM.launches
        got = fused_lstm_recurrence(xg, R, h0, c0, p)
        torch.cuda.synchronize()
        assert FUSED_LSTM.launches == before + 1
        for a, r in zip(got, plain_recurrence(xg, R, h0, c0, p)):
            assert a.dtype == bf16
            torch.testing.assert_close(a.float(), r.float(), atol=1e-2,
                                       rtol=1e-2)
    args = [torch.zeros(s, device=cuda_device, dtype=bf16) for s in
            ((8, 1, 5), (8, 16), (8, 16), (5, 64), (16, 64), (64,))]
    assert get_op("lstm_layer").select(*args).platform == "cuda"
    half = [a.half() for a in args]
    assert get_op("lstm_layer").select(*half).platform == "plain"
    assert get_op("lstm_layer")(*half)[0].dtype == torch.float16
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_lstm_recurrence(xg.half(), R.half(), h0.half(), c0.half())
    before = FUSED_LSTM.launches
    mixed = fused_lstm_recurrence(xg, R.float(), h0, c0)
    wide = fused_lstm_recurrence(xg.float(), R.float(), h0.float(),
                                 c0.float())
    torch.cuda.synchronize()
    assert FUSED_LSTM.launches == before + 2
    for a, b in zip(mixed, wide):
        assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_net_on_card_launches_kernel(cuda_device):
    """A bf16 network's decode steps on the card go through the kernel."""
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    net = TextGenerationLSTM(seed=0, dtype="bf16", units=64,
                             vocab_size=20).init(device=cuda_device)
    eng = GenerationEngine(net, slots=4, max_len=32, device=cuda_device)
    eng.generate([4], max_new_tokens=1)    # captures the decode step
    before, replays, steps = FUSED_LSTM.launches, eng.replays, eng.steps_run
    toks = eng.generate([1, 2, 3], max_new_tokens=5)
    assert len(toks) == 5
    # each decode step replays the captured graph, which launches the
    # kernel once a layer; the host counts only the prefill's launches
    assert eng.capture_launches == {FUSED_LSTM.name: 2}
    assert eng.replays - replays == eng.steps_run - steps == 5
    assert FUSED_LSTM.launches - before == 2


def _cluster_launches(fn, calls=3):
    """How many of ``calls`` calls of ``fn`` (one forward launch each,
    after a warm-up outside the profiler) went through cudaLaunchKernelEx,
    as the cluster design launches (for its cluster dimension) and the
    grid design (cooperatively), and the stream design does not."""
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
def test_cluster_kernel_against_plain_on_card(cuda_device, dtype):
    """The forward's cluster design (R resident across a thread-block
    cluster, h through distributed shared memory) at the main path's T > 1
    shapes: config #3's [64, 64, 200] with peepholes, reversed;
    TextGenerationLSTM's training [64, 64, 256] and prefill [1, 47, 256];
    and a ragged reversed [3, 5, 200]. The stream design at decode [8, 1,
    256] and past the grid's width ([5, 3, 1100] in f32, [5, 3, 1500] in
    bf16: neither a cluster nor the card's CTAs hold R). The launcher's
    choice is fwd_design's and the stream design alone launches without
    cudaLaunchKernelEx; out, hT, cT and the reserve against the plain
    version, out bit-equal with and without the reserve. f32 tolerance
    1e-4 abs (summation order); bf16 one bf16 step, |a - b| <= 2^-7
    (1 + |b|)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    past = 1100 if dt == torch.float32 else 1500
    for B, T, H, peep, rev, kind in ((64, 64, 200, True, True, "cluster"),
                                     (64, 64, 256, False, False, "cluster"),
                                     (1, 47, 256, False, False, "cluster"),
                                     (3, 5, 200, True, True, "cluster"),
                                     (8, 1, 256, False, False, "stream"),
                                     (5, 3, past, True, False, "stream")):
        design = port_lstm.launcher_design(T, B, H, dt)
        assert design == port_lstm.fwd_design(T, B, H, dt)
        assert design.kind == kind, (B, T, H)
        rnd = lambda *s, k=1.0: (torch.randn(*s, device=cuda_device,
                                             generator=g) * k).to(dt)
        x, W, b = rnd(B, T, 77), rnd(77, 4 * H, k=0.1), rnd(4 * H, k=0.1)
        R = rnd(H, 4 * H, k=0.06)
        h0, c0 = rnd(B, H, k=0.5), rnd(B, H, k=0.5)
        p = rnd(3 * H, k=0.1) if peep else None
        xg = project_gates(x, W, b, 1.0, rev)
        assert _cluster_launches(lambda: fused_lstm_recurrence(
            xg, R, h0, c0, p)) == (3 if kind == "cluster" else 0)
        before = FUSED_LSTM.launches
        got = fused_lstm_recurrence(xg, R, h0, c0, p)
        *got_r, res = fused_lstm_recurrence(xg, R, h0, c0, p,
                                            save_residuals=True)
        torch.cuda.synchronize()
        assert FUSED_LSTM.launches == before + 2
        assert all(torch.equal(a, r) for a, r in zip(got, got_r))
        *want, p_res = plain_recurrence(xg, R, h0, c0, p,
                                        save_residuals=True)
        for a, r in zip(list(got) + [res], list(want) + [p_res]):
            assert a.dtype == (torch.float32 if a is res else dt)
            a, r = a.float(), r.float()
            if dt == torch.float32:
                torch.testing.assert_close(a, r, atol=1e-4, rtol=0)
            else:
                assert bool(((a - r).abs() <= 2 ** -7 * (1 + r.abs())).all())
