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
from deeplearning4j_tpu_torch.ops.cuda import recurrent_cluster as rc

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
    # units a stream block at T == 1: the LSTM's own decode width
    units = "kDecodeUnits" if hasattr(family, "DECODE_UNITS") else "kTile"
    assert (f"(size_t)slices * tiles * {gates} * rb * kTile" in fwd
            and f"const int upb = T == 1 ? std::min(H, {units}) : H;" in fwd)
    bwd = (CSRC / f"{source}_bwd.cu").read_text()
    assert f"(size_t)rb * {gates} * H + (size_t)rb * H" in bwd


def _slots(n):
    """A card that holds ``n`` clusters at one CTA an SM, and as many as
    fit at smaller shared memory (``active_clusters`` of fwd_design)."""
    return lambda C, rows, smem: (n * (rc.CLUSTER_SMEM_CAP // smem)
                                  if smem <= rc.CLUSTER_SMEM_CAP
                                  else 0)


def _const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _cluster_text(source):
    """A cluster kernel's source and the shared layer it includes."""
    text = (CSRC / source).read_text()
    assert '#include "recurrent_cluster.cuh"' in text
    return text + (CSRC / "recurrent_cluster.cuh").read_text()


def test_cluster_layer_constants_match_the_header():
    """csrc/recurrent_cluster.cuh's constants and planner, as the Python
    mirror (ops/cuda/recurrent_cluster.py) repeats them."""
    text = (CSRC / "recurrent_cluster.cuh").read_text()
    assert _const(text, "kClusterWarps") == rc.CLUSTER_WARPS
    assert _const(text, "kClusterUnits") == rc.CLUSTER_UNITS
    sizes = re.search(r"constexpr int kClusterSizes\[\] = \{([\d, ]+)\};",
                      text).group(1)
    assert tuple(int(c) for c in sizes.split(",")) == rc.CLUSTER_SIZES
    cap = re.search(r"constexpr size_t kClusterSmemCap = (\d+) \* 1024;",
                    text)
    assert int(cap.group(1)) * 1024 == rc.CLUSTER_SMEM_CAP
    for line in (
            "return ((H + C - 1) / C + 1) & ~1;",
            "return hp * G * kClusterUnits * e +",
            "sizeof(float) * (2 * rb * hp + (size_t)kClusterWarps * G * rb "
            "* 32);",
            "if (cluster_units(H, c) <= kClusterUnits) { C = c; break; }",
            "while (rb_max < 8 && rb_max < B) rb_max *= 2;",
            "cudaError_t err = slots(1, C, kClusterSmemCap, &resident);",
            "while (rb < rb_max && (B + rb - 1) / rb > resident) rb *= 2;",
            "while (rb > 1 && smem_of(rb, C) > kClusterSmemCap) rb /= 2;",
            "if (fits >= 1) *plan = ClusterPlan{C, rb, smem};"):
        assert line in text, line


def test_a_change_to_the_cluster_header_rebuilds_the_recurrent_libraries(
        tmp_path, monkeypatch):
    """The three recurrent sources that include csrc/recurrent_cluster.cuh
    are built into libraries named by a hash of the headers too, so an
    edited header gives each a new library (no stale build is loaded)."""
    import shutil

    from deeplearning4j_tpu_torch.ops.cuda import build

    shutil.copytree(CSRC, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    libs = [build.CudaLibrary(src, {}) for src in (
        "fused_gru.cu", "fused_gru_bwd.cu", "fused_lstm.cu")]
    before = [lib.library_path() for lib in libs]
    header = tmp_path / "csrc" / "recurrent_cluster.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [lib.library_path() for lib in libs]
    assert all(a != b for a, b in zip(before, after))


def test_gru_cluster_constants_match_the_source():
    """The forward design's constants and arithmetic, read back from
    csrc/fused_gru.cu and the cluster layer it includes: fwd_design repeats
    plan_fwd."""
    text = _cluster_text("fused_gru.cu")
    assert _const(text, "kMaxSlices") == fused_gru.MAX_SLICES
    assert _const(text, "kWarps") == fused_gru.STREAM_WARPS
    for line in (
            "return ((H + C - 1) / C + 1) & ~1;",
            "return fwd_cluster_smem_bytes(rb, H, 3, sizeof(E));",
            "gru_fwd_cluster_kernel<E, decltype(r)::value>, C, smem, n);",
            "cudaError_t err = slots(1, C, kClusterSmemCap, &resident);",
            "while (rb < rb_max && (B + rb - 1) / rb > resident) rb *= 2;",
            "while (rb > 1 && smem_of(rb, C) > kClusterSmemCap) rb /= 2;",
            "if (fits >= 1) *plan = ClusterPlan{C, rb, smem};",
            "while (slices < kMaxSlices && tiles * slices < kWarps &&",
            "H >= 16 * slices * 2 &&"):
        assert line in text, line


def test_gru_bwd_cluster_constants_match_the_source():
    """The backward design's arithmetic, read back from
    csrc/fused_gru_bwd.cu: bwd_design repeats plan_bwd."""
    text = _cluster_text("fused_gru_bwd.cu")
    assert _const(text, "kMaxSlices") == fused_gru.MAX_SLICES
    assert _const(text, "kWarps") == fused_gru.STREAM_WARPS
    for line in (
            "return 3 * kClusterUnits + 4 / (int)sizeof(E);",
            "return hp * bwd_row<E>() * sizeof(E) +",
            "sizeof(float) * ((size_t)rb * 3 * 32 + 2 * (size_t)C * rb * 32);",
            "return bwd_cluster_smem_bytes<E>(rb, H, C);",
            "gru_bwd_cluster_kernel<E, decltype(r)::value>, C, smem, n);",
            "while (rb > 1 && smem_bytes(rb, H, 1) > kSmemCap) rb /= 2;",
            "while (slices < kMaxSlices && tiles * slices < kWarps &&",
            "3 * H >= 16 * slices * 2 &&",
            "(size_t)slices * tiles * rb * kTile);"):
        assert line in text, line
    # H=256, 8 rows, a cluster of 8, f32: 256 rows of 97 words of R, the
    # operands 8 x 96 and the slots 2 x 8 x 8 x 32
    assert fused_gru.bwd_cluster_smem_bytes(8, 256, 8, 4) == 4 * (
        256 * 97 + 8 * 96 + 2 * 8 * 8 * 32)
    assert fused_gru.bwd_cluster_smem_bytes(8, 256, 8, 2) == (
        2 * 256 * 98 + 4 * (8 * 96 + 2 * 8 * 8 * 32))


def test_lstm_cluster_constants_match_the_source():
    """The LSTM forward's designs, read back from csrc/fused_lstm.cu:
    fwd_design repeats plan_fwd."""
    text = _cluster_text("fused_lstm.cu")
    assert _const(text, "kDecodeUnits") == fused_lstm.DECODE_UNITS
    assert _const(text, "kMaxSlices") == fused_lstm.MAX_SLICES
    assert _const(text, "kWarps") == fused_lstm.STREAM_WARPS
    for line in (
            "return fwd_cluster_smem_bytes(rb, H, 4, sizeof(E));",
            "lstm_fwd_cluster_kernel<E, decltype(r)::value>, C, smem, n);",
            "const int upb = T == 1 ? std::min(H, kDecodeUnits) : H;",
            "while (rb > 1 && smem_bytes(rb, H, upb, 1) > kSmemCap) rb /= 2;",
            "while (slices < kMaxSlices && tiles * slices < kWarps &&",
            "H >= 16 * slices * 2 &&"):
        assert line in text, line
    assert fused_lstm.cluster_smem_bytes(8, 256, 4) == (
        256 * 4 * 32 * 4 + 4 * (2 * 8 * 256 + 8 * 4 * 8 * 32))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gru_fwd_design_boundary(dtype):
    """The cluster design takes T > 1 up to the H where a cluster of 16
    still gives a CTA at most 32 units, in f32 and in bf16; one unit more,
    and T == 1 at any H, take the stream design."""
    ok = _slots(16)
    H = max(h for h in range(1, 2048)
            if fused_gru.fwd_design(64, 64, h, dtype, ok).kind == "cluster")
    assert H == 512
    at = fused_gru.fwd_design(64, 64, H, dtype, ok)
    over = fused_gru.fwd_design(64, 64, H + 1, dtype, ok)
    assert (at.kind, at.cluster, over.kind, over.cluster) == (
        "cluster", 16, "stream", None)
    assert at.smem <= rc.CLUSTER_SMEM_CAP
    small = fused_gru.fwd_design(64, 64, 256, dtype, ok)
    assert (small.kind, small.cluster) == ("cluster", 8)
    assert fused_gru.fwd_design(64, 64, 257, dtype, ok).cluster == 16
    for h in (7, 256, 512, 1024):
        assert fused_gru.fwd_design(1, 8, h, dtype, ok).kind == "stream"
    # a card that holds no such cluster: the stream design
    none = lambda C, rows, smem: 0  # noqa: E731
    assert fused_gru.fwd_design(64, 64, 256, dtype, none).kind == "stream"
    # H = 512 in f32 fits only with fewer rows a cluster
    if dtype == F32:
        assert at.rows < 8 and fused_gru.cluster_smem_bytes(
            2 * at.rows, H, 4) > rc.CLUSTER_SMEM_CAP


@pytest.mark.parametrize("slots,B,rows", [
    (16, 64, 4), (8, 64, 8), (15, 64, 8), (64, 64, 1), (16, 1, 1),
    (16, 3, 1), (2, 3, 2), (1, 3, 4), (1, 100, 8)])
def test_gru_cluster_rows_from_the_card(slots, B, rows):
    """Rows a cluster: the fewest that let every cluster be resident at
    one CTA an SM, at most 8 and at most B rounded up to a power of two."""
    d = fused_gru.fwd_design(64, B, 256, F32, _slots(slots))
    assert (d.kind, d.rows) == ("cluster", rows)
    assert d.smem == fused_gru.cluster_smem_bytes(rows, 256, 4)


def test_gru_stream_design_rows_and_smem():
    """The stream design's rows a block and shared memory repeat the
    launcher's: up to 8 rows, halved while over the cap, then k-slices
    doubled while warps would idle (decode: one unit tile a block, so 16
    slices; T > 1 at H=1024: 32 unit tiles, so one)."""
    d = fused_gru.fwd_design(64, 64, 1024, F32, _slots(16))
    assert (d.kind, d.rows) == ("stream", 8)
    assert d.smem == 4 * (8 * 1024 + 8 * 1024 + 32 * 3 * 8 * 32)
    h = _max_h(fused_gru, 7, False)
    assert fused_gru.fwd_design(7, 64, h, F32, _slots(16)).rows == 1
    assert fused_gru.fwd_design(1, 3, 256, BF16, _slots(16)) == (
        "stream", None, 4, 4 * (4 * 256 + 4 * 32 + 16 * 3 * 4 * 32))
    # decode at H=40: each slice at least 16 long, so 2 slices
    assert fused_gru.fwd_design(1, 8, 40, F32, _slots(16)).smem == \
        fused_gru.stream_smem_bytes(8, 40, 32, 2)


@pytest.mark.parametrize("T", [1, 2, 64])
@pytest.mark.parametrize("backward", [False, True])
def test_gru_kernel_admits_what_it_did(T, backward):
    """The cluster design changes no limit: kernel_admits takes exactly
    the stream launcher's shared-memory limits, written out here, and
    every shape the cluster design takes is one the stream design takes."""
    def stream(H):
        upb = min(H, 32) if T == 1 else H
        tiles = -(-upb // 32)
        fwd = 4 * (H + upb + tiles * 3 * 32) <= 200 * 1024
        bwd = 4 * (4 * H + -(-H // 32) * 32) <= 200 * 1024
        return fwd and (not backward or bwd)

    for H in list(range(1, 600, 7)) + list(range(9000, 12500, 61)):
        for dt in (F32, BF16):
            assert fused_gru.kernel_admits(T, H, dt, backward) is stream(H)
            if fused_gru.fwd_design(T, 64, H, dt, _slots(16)).kind == \
                    "cluster":
                assert stream(H)


# the cluster designs of the GRU backward and the LSTM forward: where a
# cluster of 16 stops holding R, in f32 and bf16, and the rows a cluster
_CLUSTER_DESIGNS = {"gru_bwd": fused_gru.bwd_design,
                    "lstm_fwd": fused_lstm.fwd_design}


@pytest.mark.parametrize("dtype,kernel,H_max", [
    (F32, "gru_bwd", 512), (BF16, "gru_bwd", 512),
    (F32, "lstm_fwd", 436), (BF16, "lstm_fwd", 512)])
def test_cluster_design_boundary(dtype, kernel, H_max):
    """T > 1 takes the cluster design up to the H where a cluster of 16
    still holds R: the GRU backward's units run out first (32 a CTA at H
    = 512); the LSTM forward's R [H, 4H] in f32 fills a CTA's 227 KB first
    (at H = 436, one row a cluster). One unit more, T == 1 at any H, and a
    card that holds no such cluster take the stream design."""
    design = _CLUSTER_DESIGNS[kernel]
    ok = _slots(16)
    H = max(h for h in range(1, 1100)
            if design(64, 64, h, dtype, ok).kind == "cluster")
    assert H == H_max
    at, over = design(64, 64, H, dtype, ok), design(64, 64, H + 1, dtype, ok)
    assert (at.kind, at.cluster, over.kind, over.cluster) == (
        "cluster", 16, "stream", None)
    assert at.smem <= rc.CLUSTER_SMEM_CAP
    small = design(64, 64, 256, dtype, ok)
    assert (small.kind, small.cluster) == ("cluster", 8)
    assert design(64, 64, 257, dtype, ok).cluster == 16
    for h in (7, 200, 256, 512, 1024):
        assert design(1, 8, h, dtype, ok).kind == "stream"
    none = lambda C, rows, smem: 0  # noqa: E731
    assert design(64, 64, 256, dtype, none).kind == "stream"
    if (dtype, kernel) == (F32, "lstm_fwd"):
        assert at.rows == 1
    if kernel == "gru_bwd":  # the receive slots grow with the cluster
        assert at.smem == fused_gru.bwd_cluster_smem_bytes(
            at.rows, H, 16, 2 if dtype == BF16 else 4)


@pytest.mark.parametrize("kernel", ["gru_bwd", "lstm_fwd"])
@pytest.mark.parametrize("slots,B,rows", [
    (16, 64, 4), (8, 64, 8), (15, 64, 8), (64, 64, 1), (16, 1, 1),
    (16, 3, 1), (2, 3, 2), (1, 3, 4), (1, 100, 8)])
def test_cluster_rows_from_the_card(kernel, slots, B, rows):
    """Rows a cluster, as the GRU forward's: the fewest that let every
    cluster be resident at one CTA an SM, at most 8 and at most B rounded
    up to a power of two; the shared memory of that many rows."""
    d = _CLUSTER_DESIGNS[kernel](64, B, 256, F32, _slots(slots))
    assert (d.kind, d.cluster, d.rows) == ("cluster", 8, rows)
    assert d.smem == (fused_gru.bwd_cluster_smem_bytes(rows, 256, 8, 4)
                      if kernel == "gru_bwd"
                      else fused_lstm.cluster_smem_bytes(rows, 256, 4))


def test_stream_designs_of_the_gru_bwd_and_lstm_fwd():
    """The stream designs' rows and shared memory repeat their launchers':
    the GRU backward at H=1024 (8 rows; 32 unit tiles, so one slice) and
    T = 1; the LSTM forward at decode (DECODE_UNITS units a block, one tile,
    16 k-slices at H=256, each 16 long) and at H=1024 (8 rows, 32 unit
    tiles, so one slice)."""
    ok = _slots(16)
    assert fused_gru.bwd_design(64, 64, 1024, F32, ok) == (
        "stream", None, 8, 4 * (8 * 3 * 1024 + 8 * 1024 + 32 * 8 * 32))
    assert fused_gru.bwd_design(1, 8, 256, BF16, ok) == (
        "stream", None, 8, 4 * (8 * 768 + 8 * 256 + 2 * 8 * 8 * 32))
    assert fused_lstm.fwd_design(1, 8, 256, F32, ok) == (
        "stream", None, 8, 4 * (8 * 256 + 8 * 8 + 16 * 4 * 8 * 32))
    assert fused_lstm.fwd_design(1, 3, 5, BF16, ok) == (
        "stream", None, 4, 4 * (4 * 5 + 4 * 5 + 4 * 4 * 32))
    assert fused_lstm.fwd_design(64, 64, 1024, F32, ok) == (
        "stream", None, 8, 4 * (8 * 1024 + 8 * 1024 + 32 * 4 * 8 * 32))
    h = _max_h(fused_lstm, 7, False)
    assert fused_lstm.fwd_design(7, 64, h, F32, ok).rows == 1


@pytest.mark.parametrize("T", [1, 2, 64])
@pytest.mark.parametrize("backward", [False, True])
def test_lstm_kernel_admits_what_it_did(T, backward):
    """The cluster design changes no limit: kernel_admits takes exactly
    the stream launchers' shared-memory limits, written out here (a
    decode block holds DECODE_UNITS units), and every shape the cluster
    design takes is one the stream design takes; so does the GRU
    backward's cluster design."""
    def stream(H):
        upb = min(H, 8) if T == 1 else H
        fwd = 4 * (H + upb + -(-upb // 32) * 4 * 32) <= 200 * 1024
        bwd = 4 * (5 * H + -(-H // 32) * 32) <= 200 * 1024
        return fwd and (not backward or bwd)

    for H in list(range(1, 600, 7)) + list(range(8000, 9000, 17)) + list(
            range(51000, 51100, 3)):
        for dt in (F32, BF16):
            assert fused_lstm.kernel_admits(T, H, dt, backward) is stream(H)
            if fused_lstm.fwd_design(T, 64, H, dt, _slots(16)).kind == \
                    "cluster":
                assert stream(H)
            if fused_gru.bwd_design(T, 64, H, dt, _slots(16)).kind == \
                    "cluster":
                assert fused_gru.kernel_admits(T, H, dt, True)


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
