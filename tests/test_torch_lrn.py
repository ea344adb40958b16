"""The port's LRN (plain versions of the two kernels, the autograd Function,
the op-level entry and the plain ``lrn`` lowering) against the JAX
package, on shared numpy inputs.

``lrn_fwd_plain`` is held against the Pallas ``pallas_lrn`` in interpret
mode, and ``lrn_bwd_plain`` against ``jax.vjp`` through it (the Pallas
backward kernel), at depths 5 and 4 (the even window is asymmetric and its
backward runs over the mirrored window), 3 and 1, and C of 3 (below the
depth), 64 and 77. Tolerances are the JAX package's own for its Pallas
kernel against the XLA lowering: f32 rtol 2e-5 / atol 2e-6 forward, rtol
2e-4 / atol 2e-6 backward. In bf16 both sides compute in f32 and round the
result once, so they may differ by one bf16 step (2^-7 relative at most).
The registered plain lowering is held against the XLA lowering
(``ops.convolution.lrn``), which computes in the input's type.
``LRNFunction`` runs the plain versions on the CPU and is held against
autograd through the plain lowering. The ``cuda`` tests hold each kernel
against its plain version on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import convolution as jax_conv
from deeplearning4j_tpu.ops.pallas import pallas_lrn
from deeplearning4j_tpu_torch.ops import convolution
from deeplearning4j_tpu_torch.ops.cuda import lrn as lrn_mod
from deeplearning4j_tpu_torch.ops.cuda.lrn import (
    LRN_BWD, LRN_FWD, MAX_CHANNELS, LRNFunction, lrn_backward, lrn_bwd_plain,
    lrn_forward, lrn_fwd_plain, lrn_kernel, lrn_requires,
)
from deeplearning4j_tpu_torch.ops.registry import get_op

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
BWD_TOL = dict(rtol=2e-4, atol=2e-6)
BF16_REL = 2.0 ** -7
# AlexNet's LRN (DL4J defaults) and a wider window with a stronger alpha,
# so that the window sum moves the result well above the tolerance
HPARAMS = [dict(alpha=1e-4, beta=0.75, k=2.0),
           dict(alpha=0.5, beta=0.6, k=1.0)]
CASES = [(depth, C, hp) for depth in (5, 4) for C in (3, 64, 77)
         for hp in range(len(HPARAMS))] + [
    (3, 64, 1), (1, 64, 1), (4, 4, 1), (6, 5, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda", 0)


def _x(shape, seed, scale=2.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _pallas(x, depth, hp):
    return pallas_lrn(x, depth=depth, block_rows=8, **hp)


def _pallas_vjp(x, g, depth, hp):
    _, vjp = jax.vjp(functools.partial(_pallas, depth=depth, hp=hp), x)
    return vjp(g)[0]


def _close_bf16(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=BF16_REL,
                               atol=BF16_REL * 1e-3)


# ------------------------------------------------------- plain vs Pallas

@pytest.mark.parametrize("depth,C,hp", CASES)
def test_forward_plain_matches_pallas(depth, C, hp):
    x = _x((2, 3, 5, C), seed=depth * 100 + C)
    got = lrn_fwd_plain(torch.tensor(x), depth=depth, **HPARAMS[hp])
    want = _pallas(jnp.asarray(x), depth, HPARAMS[hp])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("depth,C,hp", CASES)
def test_backward_plain_matches_pallas_vjp(depth, C, hp):
    x = _x((2, 3, 5, C), seed=depth * 100 + C)
    g = _x((2, 3, 5, C), seed=depth * 100 + C + 1, scale=1.0)
    got = lrn_bwd_plain(torch.tensor(x), torch.tensor(g), depth=depth,
                        **HPARAMS[hp])
    want = _pallas_vjp(jnp.asarray(x), jnp.asarray(g), depth, HPARAMS[hp])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)


def test_even_depth_backward_uses_the_mirrored_window():
    """Depth 4: the closed form over the forward's own window instead of
    the mirrored one is wrong by far more than the tolerance."""
    depth, hp = 4, HPARAMS[1]
    x, g = _x((1, 2, 2, 16), 7), _x((1, 2, 2, 16), 8, scale=1.0)
    want = np.asarray(_pallas_vjp(jnp.asarray(x), jnp.asarray(g), depth, hp))
    xt, gt = torch.tensor(x), torch.tensor(g)
    np.testing.assert_allclose(
        lrn_bwd_plain(xt, gt, depth=depth, **hp).numpy(), want, **BWD_TOL)
    d = hp["k"] + hp["alpha"] * convolution.window_sum(xt * xt, -2, 1)
    u = gt * xt * d ** (-hp["beta"]) / d
    wrong = (gt * d ** (-hp["beta"]) - 2 * hp["alpha"] * hp["beta"] * xt
             * convolution.window_sum(u, -2, 1))
    assert np.abs(wrong.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("depth,C", [(5, 64), (4, 77), (5, 3)])
def test_bf16_plain_versions_match_pallas(depth, C):
    """bf16 in and out, f32 inside, on both sides."""
    hp = HPARAMS[1]
    x = _x((2, 3, 5, C), seed=C)
    g = _x((2, 3, 5, C), seed=C + 1, scale=1.0)
    xb, gb = torch.tensor(x).bfloat16(), torch.tensor(g).bfloat16()
    xj, gj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    y = lrn_fwd_plain(xb, depth=depth, **hp)
    assert y.dtype == torch.bfloat16
    _close_bf16(y, _pallas(xj, depth, hp))
    dx = lrn_bwd_plain(xb, gb, depth=depth, **hp)
    assert dx.dtype == torch.bfloat16
    _close_bf16(dx, _pallas_vjp(xj, gj, depth, hp))


# ------------------------------------------- the registered plain lowering

@pytest.mark.parametrize("depth,C,hp", CASES)
def test_plain_lowering_matches_xla_lowering(depth, C, hp):
    x = _x((2, 3, 5, C), seed=depth + C)
    got = convolution.lrn(torch.tensor(x), depth=depth, **HPARAMS[hp])
    want = jax_conv.lrn(jnp.asarray(x), depth=depth, **HPARAMS[hp])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_plain_lowering_bf16_computes_in_bf16_like_xla():
    """Both lowerings compute in bf16 (the kernels and the Pallas kernel
    in f32): they agree with each other within bf16 rounding of the
    intermediate sums."""
    hp = HPARAMS[1]
    x = _x((2, 3, 5, 64), seed=11)
    got = convolution.lrn(torch.tensor(x).bfloat16(), depth=5, **hp)
    want = jax_conv.lrn(jnp.asarray(x, jnp.bfloat16), depth=5, **hp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=4 * BF16_REL, atol=1e-3)


@pytest.mark.parametrize("hp", range(len(HPARAMS)))
def test_jax_bf16_paths_split_as_recorded(hp):
    """The reference's two bf16 paths differ: against the f32 result on the
    same bf16 input, the Pallas kernel (f32 inside, one rounding) stays
    within one bf16 step (2^-8 relative), the XLA lowering (bf16
    throughout) goes beyond it. The port's kernels and their plain versions
    follow the Pallas side, its registered plain lowering the XLA side."""
    x = jnp.asarray(_x((2, 8, 8, 96), 12), jnp.bfloat16)
    ref = np.asarray(_pallas(x.astype(jnp.float32), 5, HPARAMS[hp]))
    rel = lambda a: float((np.abs(np.asarray(a, np.float32) - ref)  # noqa
                           / np.maximum(np.abs(ref), 1e-3)).max())
    pallas = _pallas(x, 5, HPARAMS[hp]).astype(jnp.float32)
    xla = jax_conv.lrn(x, depth=5, **HPARAMS[hp]).astype(jnp.float32)
    assert rel(pallas) <= 1.01 * 2.0 ** -8
    assert 2.0 ** -8 < rel(xla) <= 2.0 ** -5
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
    assert rel(lrn_fwd_plain(xt, depth=5, **HPARAMS[hp]).float()) \
        <= 1.01 * 2.0 ** -8


# ---------------------------------------------------- Function and entry

@pytest.mark.parametrize("depth", [5, 4])
def test_function_grad_matches_autograd_through_plain_lowering(depth):
    hp = HPARAMS[1]
    x = torch.tensor(_x((2, 4, 3, 33), seed=depth))
    g = torch.tensor(_x((2, 4, 3, 33), seed=depth + 1, scale=1.0))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = LRNFunction.apply(a, depth, hp["alpha"], hp["beta"], hp["k"])
    yb = convolution.lrn(b, depth=depth, **hp)
    np.testing.assert_allclose(ya.detach().numpy(), yb.detach().numpy(),
                               **FWD_TOL)
    (ga,), (gb,) = (torch.autograd.grad(y, t, g) for y, t in
                    ((ya, a), (yb, b)))
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), **BWD_TOL)


def test_function_takes_a_non_contiguous_gradient():
    x = torch.tensor(_x((2, 3, 3, 8), 1)).requires_grad_()
    g = torch.tensor(_x((2, 8, 3, 3), 2)).permute(0, 2, 3, 1)
    assert not g.is_contiguous()
    (got,) = torch.autograd.grad(LRNFunction.apply(x, 5, 0.5, 0.6, 1.0), x, g)
    want = lrn_bwd_plain(x.detach(), g.contiguous(), depth=5, alpha=0.5,
                         beta=0.6, k=1.0)
    torch.testing.assert_close(got, want)


def test_entry_uses_the_function_only_under_autograd():
    x = torch.tensor(_x((1, 2, 2, 8), 3))
    assert lrn_kernel(x).grad_fn is None
    y = lrn_kernel(x.clone().requires_grad_())
    assert type(y.grad_fn).__name__.startswith("LRNFunction")
    with torch.no_grad():
        assert lrn_kernel(x.clone().requires_grad_()).grad_fn is None


def test_registry_sends_cpu_calls_to_plain():
    op = get_op("lrn")
    assert {i.platform for i in op.impls} == {"plain", "cuda"}
    x = torch.tensor(_x((1, 4, 4, 96), 4))
    assert op.select(x, depth=5, alpha=1e-4, beta=0.75, k=2.0).platform \
        == "plain"
    n = (LRN_FWD.launches, LRN_BWD.launches)
    torch.testing.assert_close(op(x, depth=5), convolution.lrn(x, depth=5))
    assert (LRN_FWD.launches, LRN_BWD.launches) == n


def test_choice_cache_keys_on_contiguity():
    """``lrn_requires`` reads contiguity, so the registry's cached choice
    for a shape must not serve a non-contiguous tensor of that shape."""
    from deeplearning4j_tpu_torch.ops.registry import _signature

    a = torch.empty(2, 3, 3, 8)
    b = torch.empty(2, 8, 3, 3).permute(0, 2, 3, 1)
    assert a.shape == b.shape and _signature(a) != _signature(b)


def test_requires_states_what_the_kernels_compute():
    f = lambda *s, **kw: torch.empty(*s, **kw)  # noqa: E731
    assert lrn_requires(f(2, 3, 3, 96))
    assert lrn_requires(f(2, 3, 3, 3, dtype=torch.bfloat16), depth=4)
    assert lrn_requires(f(5, MAX_CHANNELS))
    assert not lrn_requires(f(5, MAX_CHANNELS + 1))
    assert not lrn_requires(f(2, 3, 3, 96, dtype=torch.float16))
    assert not lrn_requires(f(2, 96, 3, 3).permute(0, 2, 3, 1))
    assert not lrn_requires(f(2, 3, 3, 96), depth=0)
    # no TPU threshold: few pixels and few channels are taken
    assert lrn_requires(f(1, 1, 1, 2))
    assert not lrn_mod._cuda_requires(f(2, 3, 3, 96))  # on the CPU


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor on a device other than the CPU never takes the plain
    version quietly."""
    x = torch.empty(2, 3, 3, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lrn_forward(x)
    with pytest.raises(ValueError, match="unsupported device"):
        lrn_backward(x, x)


def test_kernel_records_name_their_sources_and_pallas_kernels():
    assert LRN_FWD.source.endswith("csrc/lrn_fwd.cu")
    assert LRN_BWD.source.endswith("csrc/lrn_bwd.cu")
    assert LRN_FWD.replaces == "deeplearning4j_tpu/ops/pallas/lrn.py:31 " \
        "(_lrn_kernel)"
    assert LRN_BWD.replaces == "deeplearning4j_tpu/ops/pallas/lrn.py:84 " \
        "(_lrn_bwd_kernel)"


# ----------------------------------------------------------- on the card

def _card_tensor(a, device, dtype, offset):
    """``a`` on the card, its data ``offset`` elements past the start of an
    allocation (so past a 16-byte boundary when offset is 1): the kernels'
    element-by-element path."""
    t = torch.tensor(a).to(device, dtype)
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, device=device, dtype=dtype)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


# (shape, depth, offset): AlexNet's two LRN channel counts; even depth, C
# below the depth and C = 1; C = 4096 (one row a block) at depths 6 and 5;
# 25 pixels of 96 channels, which leave the last block of rows partial; and
# data one element past a 16-byte boundary, which takes the element path
CARD_SHAPES = [((2, 13, 13, 96), 5, 0), ((2, 7, 7, 256), 5, 0),
               ((3, 7, 5, 77), 4, 0), ((4, 3, 3, 3), 5, 0),
               ((1, 1, 1, 4096), 6, 0), ((5, 3, 3, 1), 5, 0),
               ((1, 2, 1, 4096), 5, 0), ((1, 5, 5, 96), 5, 0),
               ((2, 5, 7, 96), 5, 1), ((2, 3, 3, 256), 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,depth,offset", CARD_SHAPES)
def test_kernels_against_plain_on_card(cuda_device, shape, depth, offset,
                                       dtype):
    hp = HPARAMS[1]
    x = _card_tensor(_x(shape, 5), cuda_device, dtype, offset)
    g = _card_tensor(_x(shape, 6, scale=1.0), cuda_device, dtype, offset)
    n = (LRN_FWD.launches, LRN_BWD.launches)
    y = lrn_forward(x, depth=depth, **hp)
    dx = lrn_backward(x, g, depth=depth, **hp)
    torch.cuda.synchronize()
    assert (LRN_FWD.launches, LRN_BWD.launches) == (n[0] + 1, n[1] + 1)
    for got, want, tol in ((y, lrn_fwd_plain(x, depth=depth, **hp), FWD_TOL),
                           (dx, lrn_bwd_plain(x, g, depth=depth, **hp),
                            BWD_TOL)):
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **tol)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_function_grad_against_autograd_on_card(cuda_device):
    hp = HPARAMS[1]
    x = torch.tensor(_x((2, 9, 9, 96), 7)).to(cuda_device)
    g = torch.tensor(_x((2, 9, 9, 96), 8, scale=1.0)).to(cuda_device)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    (ga,) = torch.autograd.grad(lrn_kernel(a, depth=5, **hp), a, g)
    (gb,) = torch.autograd.grad(convolution.lrn(b, depth=5, **hp), b, g)
    torch.testing.assert_close(ga, gb, **BWD_TOL)


# (shape, depth, offset): the forward at the main path's shapes (AlexNet's
# two LRN layers at batch 128), C = 77 at even depth and C = 3 (element
# path), and AlexNet's conv1 shape one element past a 16-byte boundary
FWD_MAIN_SHAPES = [((128, 54, 54, 96), 5, 0), ((128, 26, 26, 256), 5, 0),
                   ((3, 7, 5, 77), 4, 0), ((4, 3, 3, 3), 5, 0),
                   ((8, 54, 54, 96), 5, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,depth,offset", FWD_MAIN_SHAPES)
def test_forward_against_plain_at_main_path_shapes(cuda_device, shape, depth,
                                                   offset, dtype):
    """The forward kernel against its plain version (the tolerances of
    ``test_kernels_against_plain_on_card``), with AlexNet's hyperparameters
    at depth 5 and the stronger ones elsewhere; the launcher takes the
    design that ``fwd_design`` names."""
    hp = HPARAMS[0] if depth == 5 and shape[-1] > 3 else HPARAMS[1]
    x = _card_tensor(_x(shape, 9), cuda_device, dtype, offset)
    n = LRN_FWD.launches
    y = lrn_forward(x, depth=depth, **hp)
    torch.cuda.synchronize()
    assert LRN_FWD.launches == n + 1 and y.dtype == dtype
    want = lrn_fwd_plain(x, depth=depth, **hp)
    if dtype == torch.float32:
        torch.testing.assert_close(y, want, **FWD_TOL)
    else:
        torch.testing.assert_close(y.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)
    aligned = (x.data_ptr() | y.data_ptr()) % 16 == 0
    assert aligned is not bool(offset)
    design = lrn_mod.launcher_design(shape[-1], aligned, dtype, cuda_device)
    assert design == lrn_mod.fwd_design(shape[-1], aligned, dtype)
    assert design[0] == ("vector" if shape[-1] in (96, 256) and not offset
                         else "element")
