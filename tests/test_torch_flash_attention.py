"""The port's flash attention (plain versions, autograd Function, op-level
entry and the plain ``dot_product_attention`` lowering) against the JAX
package, on shared numpy inputs.

The plain versions of the kernels are held against the JAX package's
Pallas kernels in interpret mode, with small blocks (``block_q=8,
block_k=16``) so that several blocks, the online softmax's rescaling and a
ragged tail run: the forward against ``flash_block_fwd``, the backward
against ``flash_block_bwd`` with the forward's lse and delta passed in.
``FlashAttentionFunction`` (on the CPU it runs the same assembly code as on
the card, with the plain versions) is held against ``jax.vjp`` of the
Pallas ``flash_attention``; the plain lowering against the XLA lowering.
Tolerances: f32 atol = rtol = 1e-5 (only the order of the sums differs);
bf16 2^-7 relative to the output's scale (the Pallas kernel rounds p to
bf16 against its running max, the plain version against the row's final
max, so a stored value may land one bf16 step away). The ``cuda`` tests
hold the three kernels against the plain versions on the card.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import attention as jax_attention
from deeplearning4j_tpu_torch.ops import attention
from deeplearning4j_tpu_torch.ops.cuda import flash_attention as fa
from deeplearning4j_tpu_torch.ops.cuda.flash_attention import (
    FLASH_DKV, FLASH_DQ, FLASH_FWD, FlashAttentionFunction, flash_attention,
    flash_backward, flash_backward_plain, flash_block_bwd, flash_forward,
    flash_forward_plain, flash_requires,
)
from deeplearning4j_tpu_torch.ops.registry import get_op

# the module (the package's __init__ exports a function of the same name)
jax_flash = importlib.import_module(
    "deeplearning4j_tpu.ops.pallas.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REL = 2.0 ** -7
BLOCKS = dict(block_q=8, block_k=16)


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


def _case(T, D, *, mask, B=2, N=2, Tk=None, seed=0):
    """q, k, v, do [B, N, T, D] f32 and a [B, Tk] key mask (or None) as
    numpy. ``mask``: None, "pad" (ragged lengths) or "full" (the last
    batch row sees no key at all)."""
    rng = np.random.default_rng(seed)
    Tk = T if Tk is None else Tk
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a = dict(q=f(B, N, T, D), k=f(B, N, Tk, D), v=f(B, N, Tk, D),
             do=f(B, N, T, D))
    km = None
    if mask is not None:
        lens = rng.integers(1, Tk + 1, B)
        km = (np.arange(Tk)[None, :] < lens[:, None]).astype(np.float32)
        if mask == "full":
            km[-1] = 0.0
    return a, km


def _t(a, dtype=torch.float32):
    return torch.tensor(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=BF16_REL,
                                   atol=BF16_REL * scale)


def _close_lse(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


# ------------------------------------------------------------------ forward

FWD_CASES = [(T, D, mask, causal)
             for T, D in ((16, 64), (40, 16), (40, 64))
             for mask in (None, "pad") for causal in (False, True)]


@pytest.mark.parametrize("T,D,mask,causal", FWD_CASES)
def test_forward_plain_matches_pallas(T, D, mask, causal):
    a, km = _case(T, D, mask=mask, seed=T + D)
    scale = 1.0 / math.sqrt(D)
    o, lse = flash_forward_plain(_t(a["q"]), _t(a["k"]), _t(a["v"]),
                                 scale=scale, causal=causal,
                                 kmask=None if km is None else _t(km))
    jo, jlse = jax_flash.flash_block_fwd(_j(a["q"]), _j(a["k"]), _j(a["v"]),
                               causal=causal, scale=scale,
                               kmask=None if km is None else _j(km), **BLOCKS)
    assert o.shape == tuple(jo.shape) and lse.shape == tuple(jlse.shape)
    _close(o, jo, torch.float32)
    _close_lse(lse, jlse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_gives_zero_and_inf(dtype, causal):
    """A batch whose keys are all padding: o = 0 and lse = +inf, in both
    packages (the XLA lowering would give the mean of v)."""
    a, km = _case(40, 16, mask="full", seed=3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    scale = 0.25
    o, lse = flash_forward_plain(_t(a["q"], tdt), _t(a["k"], tdt),
                                 _t(a["v"], tdt), scale=scale, causal=causal,
                                 kmask=_t(km))
    jo, jlse = jax_flash.flash_block_fwd(_j(a["q"], jdt), _j(a["k"], jdt),
                               _j(a["v"], jdt), causal=causal, scale=scale,
                               kmask=_j(km), **BLOCKS)
    assert o.dtype == tdt
    assert bool((o[1] == 0).all()) and bool(torch.isinf(lse[1]).all())
    assert np.all(np.asarray(jo[1], np.float32) == 0)
    _close(o, jo, tdt)
    _close_lse(lse, jlse)
    # the backward sees exp(s - inf) = 0 there: no gradient, no NaN
    delta = (_t(a["do"], tdt).float() * o.float()).sum(-1, keepdim=True)
    grads = flash_backward_plain(_t(a["q"], tdt), _t(a["k"], tdt),
                                 _t(a["v"], tdt), _t(a["do"], tdt), lse,
                                 delta, scale=scale, causal=causal,
                                 kmask=_t(km))
    for g in grads:
        assert bool(torch.isfinite(g).all()) and bool((g[1] == 0).all())


@pytest.mark.parametrize("mask", [None, "pad"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_bf16_matches_pallas(mask, causal):
    a, km = _case(40, 64, mask=mask, seed=7)
    bf = torch.bfloat16
    o, lse = flash_forward_plain(_t(a["q"], bf), _t(a["k"], bf),
                                 _t(a["v"], bf), scale=0.125, causal=causal,
                                 kmask=None if km is None else _t(km))
    jo, jlse = jax_flash.flash_block_fwd(
        _j(a["q"], jnp.bfloat16), _j(a["k"], jnp.bfloat16),
        _j(a["v"], jnp.bfloat16), causal=causal, scale=0.125,
        kmask=None if km is None else _j(km), **BLOCKS)
    assert o.dtype == bf and lse.dtype == torch.float32
    _close(o, jo, bf)
    # lse is f32 from bf16 products summed in f32: the sum's order only
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-4)


# ----------------------------------------------------------------- backward

BWD_CASES = [(40, 64, mask, causal, dt)
             for mask in (None, "pad") for causal in (False, True)
             for dt in ("float32", "bfloat16")] + [(16, 16, "pad", True,
                                                    "float32")]


@pytest.mark.parametrize("T,D,mask,causal,dtype", BWD_CASES)
def test_backward_plain_matches_pallas(T, D, mask, causal, dtype):
    """dq, dk, dv from an external lse and delta (the ring's global lse
    contract): both packages are given the same ones."""
    a, km = _case(T, D, mask=mask, seed=100 + T + D)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    scale = 1.0 / math.sqrt(D)
    jkm = None if km is None else _j(km)
    jq, jk, jv, jdo = (_j(a[n], jdt) for n in ("q", "k", "v", "do"))
    jo, jlse = jax_flash.flash_block_fwd(jq, jk, jv, causal=causal, scale=scale,
                               kmask=jkm, **BLOCKS)
    jdelta = (jdo.astype(jnp.float32) * jo.astype(jnp.float32)).sum(
        -1, keepdims=True)
    want = jax_flash.flash_block_bwd(jq, jk, jv, jdo, jlse, jdelta,
                                     causal=causal, scale=scale, kmask=jkm,
                                     **BLOCKS)
    # the port's block primitive takes the plain version on CPU tensors
    got = flash_block_bwd(
        *(_t(a[n], tdt) for n in ("q", "k", "v", "do")),
        torch.tensor(np.asarray(jlse)), torch.tensor(np.asarray(jdelta)),
        scale=scale, causal=causal, kmask=None if km is None else _t(km))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == tuple(w.shape)
        _close(g, w, tdt)


# ----------------------------------------------------------------- autograd

@pytest.mark.parametrize("mask,causal", [(None, False), ("pad", False),
                                         (None, True), ("pad", True)])
def test_function_grads_match_jax_vjp(mask, causal):
    """FlashAttentionFunction's CPU path (forward and backward wrappers,
    delta, the casts) against jax.vjp of the Pallas flash_attention, with a
    [B, 1, 1, Tk] bool mask as the layers pass it."""
    a, km = _case(40, 16, mask=mask, seed=11)
    bm = None if km is None else km[:, None, None, :] > 0
    jq, jk, jv = (_j(a[n]) for n in ("q", "k", "v"))
    jout, vjp = jax.vjp(
        lambda q, k, v: jax_flash.flash_attention(
            q, k, v, mask=None if bm is None else jnp.asarray(bm),
            causal=causal), jq, jk, jv)
    want = vjp(_j(a["do"]))
    q, k, v = (_t(a[n]).requires_grad_() for n in ("q", "k", "v"))
    n0 = (FLASH_FWD.launches, FLASH_DQ.launches, FLASH_DKV.launches)
    out = flash_attention(q, k, v,
                          mask=None if bm is None else torch.tensor(bm),
                          causal=causal)
    got = torch.autograd.grad(out, (q, k, v), _t(a["do"]))
    assert out.grad_fn is not None and "FlashAttention" in out.grad_fn.name()
    _close(out.detach(), jout, torch.float32)
    for g, w in zip(got, want):
        _close(g, w, torch.float32)
    # the plain versions on the CPU launch nothing
    assert (FLASH_FWD.launches, FLASH_DQ.launches, FLASH_DKV.launches) == n0


def test_forward_only_saves_nothing(monkeypatch):
    """Without autograd the op runs the forward alone; with it, the
    Function saves q, k, v, o, lse and the key mask for its backward."""
    a, km = _case(16, 16, mask="pad", seed=5)
    calls = []
    real = FlashAttentionFunction.apply
    monkeypatch.setattr(FlashAttentionFunction, "apply",
                        lambda *args: calls.append(1) or real(*args))
    q, k, v = (_t(a[n]) for n in ("q", "k", "v"))
    with torch.no_grad():
        flash_attention(q.requires_grad_(), k, v, mask=_t(km))
    assert calls == []
    out = flash_attention(q, k, v, mask=_t(km))
    assert calls == [1]
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and saved[3].shape == q.shape
    assert saved[4].shape == (2, 2, 16, 1) and saved[5].shape == (2, 16)


# ------------------------------------------------------------ plain lowering

PLAIN_CASES = [
    dict(Tq=12, Tk=12), dict(Tq=12, Tk=12, causal=True),
    dict(Tq=5, Tk=12, causal=True), dict(Tq=12, Tk=12, mask="pad"),
    dict(Tq=12, Tk=12, mask="full"), dict(Tq=7, Tk=12, mask="general"),
    dict(Tq=12, Tk=12, bias=True), dict(Tq=5, Tk=12, bias=True, causal=True,
                                        mask="pad"),
]


@pytest.mark.parametrize("case", PLAIN_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_plain_lowering_matches_xla(case):
    """The port's plain dot_product_attention against the XLA lowering:
    bias, end-aligned causal with Tq < Tk, and finfo.min masking (a row
    with no key gets the mean of v)."""
    rng = np.random.default_rng(21)
    B, N, D, Tq, Tk = 2, 3, 8, case["Tq"], case["Tk"]
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = f(B, N, Tq, D), f(B, N, Tk, D), f(B, N, Tk, D)
    kw = dict(causal=case.get("causal", False))
    jkw = dict(kw)
    if case.get("bias"):
        b = f(B, 1, Tq, Tk)
        kw["bias"], jkw["bias"] = torch.tensor(b), jnp.asarray(b)
    m = case.get("mask")
    if m in ("pad", "full"):
        mm = np.ones((B, 1, 1, Tk), bool)
        mm[0, ..., 3:] = False
        if m == "full":
            mm[1] = False
    elif m == "general":
        mm = rng.uniform(size=(B, N, Tq, Tk)) > 0.3
    if m is not None:
        kw["mask"], jkw["mask"] = torch.tensor(mm), jnp.asarray(mm)
    want = jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    got = attention.dot_product_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (False, True)])
def test_multi_head_attention_matches_jax(masked, causal):
    rng = np.random.default_rng(4)
    B, T, F, D, H = 2, 10, 12, 16, 4
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    x = f(B, T, F)
    ws = [f(F, D, sc=0.3) for _ in range(3)] + [f(D, F, sc=0.3)]
    bs = [f(D, sc=0.1) for _ in range(3)] + [f(F, sc=0.1)]
    mm = None
    if masked:
        mm = np.ones((B, 1, 1, T), bool)
        mm[1, ..., 6:] = False
    names = ("bq", "bk", "bv", "bo")
    want = jax_attention.multi_head_attention(
        jnp.asarray(x), jnp.asarray(x), *map(jnp.asarray, ws), n_heads=H,
        mask=None if mm is None else jnp.asarray(mm), causal=causal,
        **dict(zip(names, map(jnp.asarray, bs))))
    got = attention.multi_head_attention(
        _t(x), _t(x), *map(_t, ws), n_heads=H,
        mask=None if mm is None else torch.tensor(mm), causal=causal,
        **dict(zip(names, map(_t, bs))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------- requires

REQUIRES_CASES = [
    dict(), dict(mask=(2, 9)), dict(mask=(1, 9)), dict(mask=(2, 1, 1, 9)),
    dict(mask=(1, 1, 1, 9)), dict(mask=(2, 3, 9, 9)), dict(mask=(2, 1, 9, 9)),
    dict(mask=(2, 8)), dict(mask=(3, 9)), dict(bias=True),
    dict(causal=True), dict(causal=True, Tq=4), dict(Tq=4),
    dict(mask=(2, 9), causal=True), dict(D=128),
]


@pytest.mark.parametrize("case", REQUIRES_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items())
                         or "plain")
def test_requires_matches_jax(case):
    B, N, Tq, Tk, D = 2, 3, case.get("Tq", 9), 9, case.get("D", 8)
    q, k = np.zeros((B, N, Tq, D), np.float32), np.zeros((B, N, Tk, D),
                                                          np.float32)
    kw = dict(causal=case.get("causal", False))
    jkw = dict(kw)
    if "mask" in case:
        mm = np.ones(case["mask"], bool)
        kw["mask"], jkw["mask"] = torch.tensor(mm), jnp.asarray(mm)
    if case.get("bias"):
        kw["bias"] = torch.zeros(B, N, Tq, Tk)
        jkw["bias"] = jnp.zeros((B, N, Tq, Tk))
    want = jax_flash._flash_requires(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(k), **jkw)
    assert flash_requires(_t(q), _t(k), _t(k), **kw) == want


def test_requires_head_dim_limit_and_cpu_routing():
    """The kernels stop at head dim 128 (the JAX kernel has no such limit);
    a CPU call always takes the plain lowering."""
    q = torch.zeros(1, 1, 4, 160)
    assert not flash_requires(q, q, q)
    assert flash_requires(q[..., :128], q[..., :128], q[..., :128])
    assert not fa._cuda_requires(q[..., :64], q[..., :64], q[..., :64])
    op = get_op("dot_product_attention")
    assert op.select(q, q, q).platform == "plain"


def test_wrapper_checks():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check("t", q.half(), q.half(), q.half(), None)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 2, 4, 130)
        fa._check("t", big, big, big, None)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check("t", q, q.transpose(2, 3).contiguous().transpose(2, 3), q,
                  None)
    with pytest.raises(ValueError, match="kmask"):
        fa._check("t", q, q, q, torch.ones(1, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, bias=torch.zeros(1))
    with pytest.raises(ValueError, match="key-padding"):
        fa.as_key_padding(torch.ones(1, 2, 4, 4), 1, 4)


# --------------------------------------------------------------- on the card

def _card_inputs(device, B, N, T, D, dtype, mask, seed):
    a, km = _case(T, D, mask=mask, B=B, N=N, seed=seed)
    t = {n: _t(x, dtype).to(device) for n, x in a.items()}
    return t, None if km is None else _t(km).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 128, 64), (2, 2, 77, 64),
                                   (1, 2, 300, 128), (1, 1, 40, 16),
                                   (2, 2, 40, 72), (2, 2, 1, 64)])
def test_kernels_against_plain_on_card(cuda_device, shape, dtype):
    """o, lse, dq, dk, dv of the three kernels against the plain versions
    on the card, unmasked, key-padded and with a batch row that sees no key,
    causal and not; D = 72 pads the bf16 tiles, T = 1 is one row. Exactly
    one launch of each kernel a case. Tolerance 1e-4 in f32 (sums in other
    orders), 1e-2 (1 + |ref|) in bf16."""
    dt = getattr(torch, dtype)
    B, N, T, D = shape
    for mask in (None, "pad", "full"):
        for causal in (False, True):
            t, km = _card_inputs(cuda_device, B, N, T, D, dt, mask, T + D)
            kw = dict(scale=1.0 / math.sqrt(D), causal=causal, kmask=km)
            n0 = FLASH_FWD.launches, FLASH_DQ.launches, FLASH_DKV.launches
            o, lse = flash_forward(t["q"], t["k"], t["v"], **kw)
            delta = (t["do"].float() * o.float()).sum(-1, keepdim=True)
            got = flash_backward(t["q"], t["k"], t["v"], t["do"], lse, delta,
                                 **kw)
            torch.cuda.synchronize()
            assert (FLASH_FWD.launches, FLASH_DQ.launches,
                    FLASH_DKV.launches) == tuple(n + 1 for n in n0)
            po, plse = flash_forward_plain(t["q"], t["k"], t["v"], **kw)
            want = flash_backward_plain(t["q"], t["k"], t["v"], t["do"], lse,
                                        delta, **kw)
            tol = 1e-4 if dt == torch.float32 else 1e-2
            for a, b in [(o, po), (lse, plse)] + list(zip(got, want)):
                a, b = a.float(), b.float()
                fin = torch.isfinite(b)
                assert torch.equal(fin, torch.isfinite(a))
                err = (a[fin] - b[fin]).abs()
                lim = tol if dt == torch.float32 else tol * (1 + b[fin].abs())
                assert bool((err <= lim).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 72, 128])
@pytest.mark.parametrize("T,Tk", [(1, 1), (128, 128), (200, 200), (77, 130),
                                  (130, 77)])
def test_bf16_dkv_against_plain_on_card(cuda_device, D, T, Tk):
    """The bf16 dk/dv kernel (tensor cores) against the plain backward on
    the card, at head dims 64, 72 (padded tiles) and 128 (two column
    blocks), T 1, 128 and 200 with causal and not, and Tq != Tk (not
    causal: the kernels are start-aligned); unmasked, key-padded and with
    a batch row that sees no key (lse = +inf). One bf16 step:
    1e-2 (1 + |ref|), on the kernel's own lse and delta."""
    dt = torch.bfloat16
    for mask in (None, "pad", "full"):
        for causal in ((False, True) if T == Tk else (False,)):
            a, km = _case(T, D, mask=mask, B=2, N=3, Tk=Tk, seed=T + D)
            t = {n: _t(x, dt).to(cuda_device) for n, x in a.items()}
            km = None if km is None else _t(km).to(cuda_device)
            kw = dict(scale=1.0 / math.sqrt(D), causal=causal, kmask=km)
            o, lse = flash_forward(t["q"], t["k"], t["v"], **kw)
            delta = (t["do"].float() * o.float()).sum(-1, keepdim=True)
            n0 = FLASH_DKV.launches
            _, dk, dv = flash_backward(t["q"], t["k"], t["v"], t["do"], lse,
                                       delta, **kw)
            torch.cuda.synchronize()
            assert FLASH_DKV.launches == n0 + 1
            _, pdk, pdv = flash_backward_plain(t["q"], t["k"], t["v"],
                                               t["do"], lse, delta, **kw)
            for got, want in ((dk, pdk), (dv, pdv)):
                assert bool(torch.isfinite(got).all())
                err = (got - want).abs()
                assert bool((err <= 1e-2 * (1 + want.abs())).all()), (
                    mask, causal, float(err.max()))


@pytest.mark.cuda
def test_function_grads_against_autograd_on_card(cuda_device):
    """Gradients through the kernels against autograd through the plain
    lowering on the card (f32, key padding, every key row valid)."""
    t, km = _card_inputs(cuda_device, 2, 3, 128, 64, torch.float32, "pad", 9)
    bm = km[:, None, None, :] > 0
    leaves = [t[n].clone().requires_grad_() for n in ("q", "k", "v")]
    got = torch.autograd.grad(flash_attention(*leaves, mask=bm), leaves,
                              t["do"])
    want = torch.autograd.grad(attention.dot_product_attention(
        *leaves, mask=bm), leaves, t["do"])
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(
            b.abs().max()))


def _tensor_core_product_inputs(device):
    g = np.random.default_rng(11)
    a = torch.tensor(g.normal(size=(64, 128)), dtype=torch.bfloat16)
    b = torch.tensor(g.normal(size=(64, 128)), dtype=torch.bfloat16)
    return a.to(device), b.to(device)


@pytest.mark.cuda
def test_tensor_core_tile_layer_on_card(cuda_device):
    """The bf16 kernels' tile layer (swizzled tiles, wgmma descriptors,
    register fragments) on one product of each kind against the host's
    f32 product of the same bf16 values: a b^T with both operands from
    shared memory over K = 128, and a[:, :64] b with A from registers and B
    read transposed. Only the order of f32 sums differs: 1e-4 (1 + |ref|)."""
    a, b = _tensor_core_product_inputs(cuda_device)
    ss, rs = fa.tile_check(a, b)
    torch.cuda.synchronize()
    af, bf = a.cpu().float(), b.cpu().float()
    for got, want in ((ss, af @ bf.T), (rs, af[:, :64] @ bf)):
        err = (got.cpu() - want).abs()
        assert bool((err <= 1e-4 * (1 + want.abs())).all()), float(err.max())


@pytest.mark.cuda
def test_bf16_kernels_run_on_tensor_cores_on_card(cuda_device):
    """The bf16 forward, dq and dk/dv compiled to wgmma (HGMMA in their
    machine code); the f32 dq and dk/dv to three-pass TF32 mma.sync (HMMA
    with .TF32, no HGMMA); the f32 forward stays on the CUDA cores (no
    tensor-core instruction): a profile of each dtype's calls names its
    own kernels."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops.cuda.build import tensor_core_ops

    for kern, names in ((FLASH_FWD, fa.FWD_KERNEL_NAMES),
                        (FLASH_DQ, fa.DQ_KERNEL_NAMES),
                        (FLASH_DKV, fa.DKV_KERNEL_NAMES)):
        assert tensor_core_ops(kern.library,
                               names[torch.bfloat16])["HGMMA"] > 0
    assert tensor_core_ops(FLASH_FWD.library,
                           fa.FWD_KERNEL_NAMES[torch.float32]) == {
        "HGMMA": 0, "HMMA": 0}
    for kern, names in ((FLASH_DQ, fa.DQ_KERNEL_NAMES),
                        (FLASH_DKV, fa.DKV_KERNEL_NAMES)):
        ops = tensor_core_ops(kern.library, names[torch.float32])
        tf32 = tensor_core_ops(kern.library, names[torch.float32], "TF32")
        assert ops["HGMMA"] == 0 and tf32["HMMA"] > 0
        assert tf32["HMMA"] == ops["HMMA"]  # every one of them TF32
    for dt in (torch.float32, torch.bfloat16):
        t, km = _card_inputs(cuda_device, 2, 2, 128, 64, dt, "pad", 3)
        kw = dict(scale=0.125, causal=False, kmask=km)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            o, lse = flash_forward(t["q"], t["k"], t["v"], **kw)
            delta = (t["do"].float() * o.float()).sum(-1, keepdim=True)
            flash_backward(t["q"], t["k"], t["v"], t["do"], lse, delta, **kw)
            torch.cuda.synchronize()
        names = " ".join(e.key for e in prof.key_averages())
        other = torch.bfloat16 if dt == torch.float32 else torch.float32
        for table in (fa.FWD_KERNEL_NAMES, fa.DQ_KERNEL_NAMES,
                      fa.DKV_KERNEL_NAMES):
            assert table[dt] in names
            # neither f32 name is a substring of a bf16 one, nor back
            assert table[other] not in names


def _against_plain(cuda_device, B, N, T, D, *, causal, mask, qk_scale, seed):
    """The f32 dq, dk, dv of the kernels and of the plain backward on the
    kernels' own lse and delta, with q and k scaled by ``qk_scale``."""
    t, km = _card_inputs(cuda_device, B, N, T, D, torch.float32, mask, seed)
    q, k = t["q"] * qk_scale, t["k"] * qk_scale
    kw = dict(scale=1.0 / math.sqrt(D), causal=causal, kmask=km)
    o, lse = flash_forward(q, k, t["v"], **kw)
    delta = (t["do"] * o).sum(-1, keepdim=True)
    n0 = FLASH_DQ.launches, FLASH_DKV.launches
    got = flash_backward(q, k, t["v"], t["do"], lse, delta, **kw)
    torch.cuda.synchronize()
    assert (FLASH_DQ.launches, FLASH_DKV.launches) == (n0[0] + 1, n0[1] + 1)
    want = flash_backward_plain(q, k, t["v"], t["do"], lse, delta, **kw)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 128, 64), (1, 2, 300, 128)])
def test_f32_backward_large_logits_on_card(cuda_device, shape, causal):
    """The three-pass TF32 dq and dk/dv with q and k scaled by 8 (logits
    of about +-500 before the scale: the split's dropped terms weigh most
    and p is nearly one-hot), key-padded, against the plain f32 backward:
    1e-4 of the output's scale, max(1, max |ref|), as the Function's
    gradients are held. The gradients reach |20|, where f32 summed in
    another order than the plain version's is 1e-3 from float64
    (tests/test_torch_tf32_split.py): an absolute 1e-4 there holds only a
    kernel that sums in the plain version's order."""
    got, want = _against_plain(cuda_device, *shape, causal=causal,
                               mask="pad", qk_scale=8.0, seed=sum(shape))
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(1.0, float(b.abs().max())), err


@pytest.mark.cuda
def test_f32_backward_t1024_causal_d128_on_card(cuda_device):
    """The three-pass TF32 dq and dk/dv at T = 1024, causal, D = 128 (16
    key tiles a query tile: the longest sums of the card tests), against
    the plain f32 backward at the card tests' f32 1e-4."""
    got, want = _against_plain(cuda_device, 1, 2, 1024, 128, causal=True,
                               mask=None, qk_scale=1.0, seed=1024)
    for a, b in zip(got, want):
        err = (a - b).abs()
        assert bool((err <= 1e-4).all()), float(err.max())
