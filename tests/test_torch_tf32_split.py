"""The arithmetic of the f32 flash backward's three-pass TF32 products
(``csrc/flash_common.cuh``, flash::tf32), emulated on the CPU.

The kernels split each f32 operand x as hi = tf32(x) and
lo = tf32(x - hi), tf32 rounding to nearest with ties away from zero by
integer arithmetic on the bit pattern (``(u + 0x1000) & 0xffffe000``), and
compute a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi a k8 step at a time into
a fresh f32 partial, added to the running f32 sum. A tf32 value has 11
significant bits, so every such product is exact in f32, and the passes
are emulated here as f32 matrix products of the split parts. Against float64, at the tile shapes of the f32 backward
(q kᵀ and do vᵀ: [64, D] x [D, 64]; ds k, pᵀ do, dsᵀ q: [64, 64] x
[64, D]; D 64 and 128) and with q and k at scale 1 and 8:

- the three-pass product lies within 3 * 2^-22 |a| |b| plus the f32
  sums' own bound (3 n * 2^-24 |a| |b| for the 3 n additions), elementwise;
- a whole backward (dq, dk, dv) made of such products is within the card
  checks' f32 1e-4 (absolute at scale 1, of the output's scale at 8, where
  f32 itself is 1e-3 from float64), and a single TF32 pass misses it: the
  control that shows the check sees the lost bits.

The emulation lives here, not in the port.
"""

import math

import numpy as np
import pytest
import torch

U = 2.0 ** -24  # f32 unit roundoff


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to tf32 as the kernels round it: the bit pattern
    plus half a tf32 ulp, the low 13 bits cleared."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(
        torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b as the kernels take it: a k8 step at a time, three TF32 passes
    (the small terms first) into a fresh f32 partial, added to the running
    f32 sum."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = None
    for j in range(0, a.shape[-1], 8):
        k = slice(j, j + 8)
        t = al[..., k] @ bh[..., k, :]
        t = t + ah[..., k] @ bl[..., k, :]
        t = t + ah[..., k] @ bh[..., k, :]
        acc = t if acc is None else acc + t
    return acc


def mm1(a, b):
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def _rng_tensor(rng, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape).astype(np.float32)) * scale


def test_round_is_nearest_ties_away_and_representable():
    rng = np.random.default_rng(0)
    x = torch.cat([_rng_tensor(rng, 4096, scale=s) for s in (1e-3, 1.0, 1e4)])
    r = tf32(x)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())  # 10 mantissa bits left
    rel = ((r.double() - x.double()).abs() / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -11
    # a tie (exactly half a tf32 ulp above 1) goes away from zero
    one_and_half_ulp = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32(one_and_half_ulp).tolist() == [1.0 + 2.0 ** -10,
                                              -(1.0 + 2.0 ** -10)]
    assert tf32(torch.tensor([1.0 + 2.0 ** -12])).item() == 1.0


def test_split_keeps_22_bits():
    rng = np.random.default_rng(1)
    x = _rng_tensor(rng, 8192, scale=8.0)
    hi, lo = split(x)
    assert torch.equal(x - hi + hi, x)  # x - hi is exact in f32
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert float((rest / x.double().abs()).max()) <= 2.0 ** -22
    # a product of two tf32 values is exact in f32
    a, b = hi[:4096], hi[4096:]
    assert torch.equal((a * b).double(), a.double() * b.double())


# the products of the f32 backward at its tile shapes: (name, rows, depth,
# columns, scale of a, scale of b)
PRODUCTS = [("q_kT", 64, 0, 64, "qk", "qk"), ("do_vT", 64, 0, 64, 1.0, 1.0),
            ("ds_k", 64, 64, 0, 1.0, "qk"), ("pT_do", 64, 64, 0, "p", 1.0),
            ("dsT_q", 64, 64, 0, 1.0, "qk")]


def _operands(name, D, qk, rng):
    rows, depth, cols = next((r, d, c) for n, r, d, c, _, _ in PRODUCTS
                             if n == name)
    depth, cols = depth or D, cols or D
    sa, sb = next((a, b) for n, _, _, _, a, b in PRODUCTS if n == name)
    if sa == "p":  # a probability tile: rows of a softmax
        a = torch.softmax(_rng_tensor(rng, rows, depth, scale=qk), -1)
    else:
        a = _rng_tensor(rng, rows, depth, scale=qk if sa == "qk" else sa)
    b = _rng_tensor(rng, depth, cols, scale=qk if sb == "qk" else sb)
    return a, b


@pytest.mark.parametrize("qk", [1.0, 8.0])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", [p[0] for p in PRODUCTS])
def test_three_pass_product_within_bound(name, D, qk):
    """Each product of the backward's tiles, three-pass, against float64:
    within 3 * 2^-22 |a| |b| + 3 n u |a| |b| elementwise (n the depth),
    the f32 product within its own n u |a| |b|; one pass 10x past the
    split's 3 * 2^-22 and 10x the three-pass error."""
    rng = np.random.default_rng(D + int(qk))
    a, b = _operands(name, D, qk, rng)
    n = a.shape[1]
    exact = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    err3 = (mm3(a, b).double() - exact).abs()
    assert bool((err3 <= (3 * 2.0 ** -22 + 3 * n * U) * mag).all())
    err32 = ((a @ b).double() - exact).abs()
    assert bool((err32 <= n * U * mag).all())
    err1 = (mm1(a, b).double() - exact).abs()
    assert float((err1 / mag).max()) > 10 * 3 * 2.0 ** -22
    assert float(err1.max()) > 10 * float(err3.max())


def _backward(q, k, v, do, lse, delta, scale, valid, mm):
    """The f32 backward's function (flash_backward_plain's) with every
    product taken by ``mm``."""
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse).masked_fill(~valid, 0.0)
    dp = mm(do, v.transpose(-1, -2))
    ds = (p * (dp - delta)).masked_fill(~valid, 0.0)
    return (scale * mm(ds, k), scale * mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _reference_case(B, N, T, D, qk, causal, seed):
    """Inputs (f32), the float64 backward, and lse and delta (f32, from
    float64) as the kernels take them."""
    rng = np.random.default_rng(seed)
    q, k = (_rng_tensor(rng, B, N, T, D, scale=qk) for _ in range(2))
    v, do = (_rng_tensor(rng, B, N, T, D) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    valid = torch.ones(T, T, dtype=torch.bool)
    if causal:
        valid = valid.tril()
    d = [t.double() for t in (q, k, v, do)]
    s = (d[0] @ d[1].transpose(-1, -2) * scale).masked_fill(~valid,
                                                            -math.inf)
    lse = torch.logsumexp(s, -1, keepdim=True)
    delta = (d[3] * (torch.softmax(s, -1) @ d[2])).sum(-1, keepdim=True)
    ref = _backward(*d, lse, delta, scale, valid, torch.matmul)
    return (q, k, v, do, lse.float(), delta.float(), scale, valid), ref


def _worst(got, ref, relative):
    out = 0.0
    for a, b in zip(got, ref):
        err = float((a.double() - b).abs().max())
        out = max(out, err / max(1.0, float(b.abs().max())) if relative
                  else err)
    return out


@pytest.mark.parametrize("B,N,T,D,qk,causal", [
    (2, 3, 128, 64, 1.0, False), (1, 2, 300, 128, 1.0, True),
    (2, 3, 128, 64, 8.0, False), (1, 2, 300, 128, 8.0, True)])
def test_three_pass_backward_within_card_tolerance(B, N, T, D, qk, causal):
    """dq, dk, dv made of three-pass products against float64: within
    1e-4 (absolute at scale 1; of the output's scale with q and k x 8,
    where f32 itself misses an absolute 1e-4); one TF32 pass misses it."""
    args, ref = _reference_case(B, N, T, D, qk, causal, seed=T + D)
    relative = qk != 1.0
    three = _worst(_backward(*args, mm3), ref, relative)
    one = _worst(_backward(*args, mm1), ref, relative)
    assert three <= 1e-4, three
    assert one > 1e-4, one
    if relative:  # where an absolute 1e-4 is out of f32's reach
        assert _worst(_backward(*args, torch.matmul), ref, False) > 1e-4
