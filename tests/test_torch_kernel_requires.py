"""What each kernel's ``requires`` admits, decided from shapes and dtypes
alone, with no card.

A call that a kernel admits launches that kernel or raises; a call that no
kernel can compute goes to the plain lowering. So each ``requires`` states
the kernels' limits:

- the fused LSTM and GRU: f32 or bf16 (the call's promoted type), and H
  under the limit that the launchers' shared-memory arithmetic gives (a
  block keeps all of h when T > 1, and in every backward). The Python
  arithmetic (``fwd_smem_bytes``, ``bwd_smem_bytes``) repeats the .cu
  ``smem_bytes``; its constants are read back from the sources here.
- flash attention: q, k and v of one type, f32 or bf16.

The ``requires`` functions see every tensor on the card; here the tensors
are shape-only (meta) tensors that say they are on the card, so the choice
runs at any size without memory.
"""

import re
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch.ops.cuda import flash_attention as fa
from deeplearning4j_tpu_torch.ops.cuda import fused_gru, fused_lstm

CSRC = Path(fused_lstm.__file__).resolve().parents[2] / "csrc"
F32, BF16 = torch.float32, torch.bfloat16


class _OnCard(torch.Tensor):
    """A meta tensor that reports itself on the card."""

    @property
    def is_cuda(self):
        return True


def _t(*shape, dtype=F32, grad=False):
    return torch.empty(shape, device="meta", dtype=dtype,
                       requires_grad=grad).as_subclass(_OnCard)


def _max_h(family, T, backward):
    """The largest H the family's kernels admit (f32)."""
    lo, hi = 1, 1 << 17
    assert family.kernel_admits(T, lo, F32, backward)
    assert not family.kernel_admits(T, hi, F32, backward)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if family.kernel_admits(T, mid, F32,
                                                   backward) else (lo, mid)
    return lo


@pytest.mark.parametrize("family,source,gates", [
    (fused_lstm, "fused_lstm", 4), (fused_gru, "fused_gru", 3)])
def test_constants_match_the_sources(family, source, gates):
    for name in (f"{source}.cu", f"{source}_bwd.cu"):
        text = (CSRC / name).read_text()
        tile = int(re.search(r"constexpr int kTile = (\d+);", text).group(1))
        cap = re.search(r"constexpr size_t kSmemCap = (\d+) \* 1024;", text)
        assert tile == family.SMEM_TILE
        assert int(cap.group(1)) * 1024 == family.SMEM_CAP
    fwd = (CSRC / f"{source}.cu").read_text()
    assert (f"(size_t)slices * tiles * {gates} * rb * kTile" in fwd
            and "const int upb = T == 1 ? std::min(H, kTile) : H;" in fwd)
    bwd = (CSRC / f"{source}_bwd.cu").read_text()
    assert f"(size_t)rb * {gates} * H + (size_t)rb * H" in bwd


@pytest.mark.parametrize("family,per_unit", [(fused_lstm, 24),
                                             (fused_gru, 20)])
@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("backward", [False, True])
def test_hidden_limit_boundary(family, per_unit, T, backward):
    """Just under and just over the limit, for T = 1 (units split across
    blocks: only the backward bounds H) and T > 1 (a block holds all of h),
    forward alone and with the backward."""
    h = _max_h(family, T, backward)
    fwd = family.fwd_smem_bytes(T, h)
    assert fwd <= family.SMEM_CAP
    if backward:
        assert family.bwd_smem_bytes(h) <= family.SMEM_CAP
    over = family.fwd_smem_bytes(T, h + 1) > family.SMEM_CAP or (
        backward and family.bwd_smem_bytes(h + 1) > family.SMEM_CAP)
    assert over
    if T > 1 or backward:  # about per_unit bytes a hidden unit
        assert abs(h - family.SMEM_CAP // per_unit) < 64
    else:  # T == 1 forward: one tile of units a block, H only in the carry
        assert h > 40000
    for H, ok in ((h, True), (h + 1, False)):
        for dt in (F32, BF16):
            assert family.kernel_admits(T, H, dt, backward) is ok


@pytest.mark.parametrize("family", [fused_lstm, fused_gru])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_types_take_the_plain_lowering(family, dtype):
    assert not family.kernel_admits(5, 256, dtype, False)
    assert family.kernel_admits(5, 256, F32, False)
    assert family.kernel_admits(5, 256, BF16, True)


def _lstm_args(B, T, F, H, dtype=F32, grad=False, carry=None):
    carry = carry or dtype
    return (_t(B, T, F, dtype=dtype), _t(B, H, dtype=carry),
            _t(B, H, dtype=carry), _t(F, 4 * H, dtype=dtype, grad=grad),
            _t(H, 4 * H, dtype=dtype, grad=grad), _t(4 * H, dtype=dtype))


def _gru_args(B, T, F, H, dtype=F32, grad=False, carry=None):
    carry = carry or dtype
    return (_t(B, T, F, dtype=dtype), _t(B, H, dtype=carry),
            _t(F, 3 * H, dtype=dtype, grad=grad),
            _t(H, 3 * H, dtype=dtype, grad=grad), _t(3 * H, dtype=dtype))


@pytest.mark.parametrize("family,requires,args", [
    (fused_lstm, fused_lstm._lstm_requires, _lstm_args),
    (fused_gru, fused_gru._gru_requires, _gru_args)])
def test_requires_decides_from_shapes_and_types(family, requires, args):
    """The registered ``requires`` on whole calls: the limit of the
    kernels the call runs (the backward's only when autograd will need it),
    the promoted type, and T = 1's own forward limit."""
    for T, grad in ((7, False), (7, True), (1, True)):
        h = _max_h(family, T, grad)
        assert requires(*args(2, T, 5, h, grad=grad))
        assert not requires(*args(2, T, 5, h + 1, grad=grad))
        with torch.no_grad():  # serving: no backward will run
            assert requires(*args(2, T, 5, h, grad=grad))
    # T = 1 splits units across blocks: the forward takes far more H than
    # the backward, so a call past the backward's limit is admitted only
    # where no backward will run
    hb = _max_h(family, 1, True)
    assert not requires(*args(2, 1, 5, hb + 1, grad=True))
    with torch.no_grad():
        assert requires(*args(2, 1, 5, hb + 1, grad=True))
    assert requires(*args(2, 1, 5, hb + 1, grad=False))
    h1 = _max_h(family, 1, False)
    assert requires(*args(8, 1, 5, h1))
    assert not requires(*args(8, 1, 5, h1 + 1))
    # an f32 carry beside bf16 weights (rnn_time_step) runs in f32
    assert requires(*args(3, 1, 5, 64, dtype=BF16, carry=F32))
    for dt in (torch.float16, torch.float64):
        assert not requires(*args(3, 4, 5, 64, dtype=dt))
    # the CPU never reaches a kernel
    cpu = [torch.empty(a.shape, device="meta", dtype=a.dtype)
           for a in args(3, 4, 5, 64)]
    assert not requires(*cpu)


@pytest.mark.parametrize("dtype,ok", [(F32, True), (BF16, True),
                                      (torch.float16, False),
                                      (torch.float64, False)])
def test_flash_requires_f32_or_bf16(dtype, ok):
    q = _t(2, 3, 16, 64, dtype=dtype)
    assert fa.kernel_admits(q, q, q) is ok
    assert fa._cuda_requires(q, q, q) is ok
    assert fa._cuda_requires(q, q, q, mask=_t(2, 16)) is ok
    assert not fa._cuda_requires(q, q, q, bias=_t(2, 3, 16, 16))


def test_flash_requires_one_type():
    q, k = _t(2, 3, 16, 64), _t(2, 3, 16, 64, dtype=BF16)
    assert not fa.kernel_admits(q, k, k)
    assert not fa.kernel_admits(k, q, k)
    assert fa.kernel_admits(k, k, k)


def test_registry_keys_the_choice_on_grad_need():
    """The recurrent kernels' backward limit makes the choice depend on
    whether autograd will run it: the cache keys on it."""
    from deeplearning4j_tpu_torch.ops.registry import _signature

    a, b = torch.zeros(2, 3), torch.zeros(2, 3, requires_grad=True)
    assert _signature(a) != _signature(b)
