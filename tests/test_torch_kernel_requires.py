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
- LRN: f32 or bf16, contiguous, 1 <= C <= 4096, depth >= 1; the
  forward's layout (``lrn.fwd_design``) is read back from
  ``csrc/lrn_fwd.cu`` and ``csrc/lrn_common.cuh``.

The ``requires`` functions see every tensor on the card; here the tensors
are shape-only (meta) tensors that say they are on the card, so the choice
runs at any size without memory.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch.ops.cuda import flash_attention as fa
from deeplearning4j_tpu_torch.ops.cuda import fused_gru, fused_lstm, lrn
from deeplearning4j_tpu_torch.ops.cuda import recurrent_cluster as rc
from deeplearning4j_tpu_torch.ops.cuda import recurrent_grid as rg

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


def _sms(n):
    """A card of ``n`` SMs: the CTAs of a grid kernel it holds at once, as
    many an SM as fit in its shared memory (``co_resident`` of
    fwd_design)."""
    return lambda rows, smem: n * (rg.GRID_SMEM_CAP // smem)


#: the H100's 132 SMs
H100 = _sms(132)


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
    """The four recurrent sources that include csrc/recurrent_cluster.cuh
    are built into libraries named by a hash of the headers too, so an
    edited header gives each a new library (no stale build is loaded)."""
    import shutil

    from deeplearning4j_tpu_torch.ops.cuda import build

    shutil.copytree(CSRC, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    sources = ("fused_gru.cu", "fused_gru_bwd.cu", "fused_lstm.cu",
               "fused_lstm_bwd.cu")
    for src in sources:
        assert '#include "recurrent_cluster.cuh"' in (
            tmp_path / "csrc" / src).read_text()
    libs = [build.CudaLibrary(src, {}) for src in sources]
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
            "return G * kClusterUnits + 4 / (int)sizeof(E);",
            "return hp * bwd_row<E, G>() * sizeof(E) +",
            "sizeof(float) * ((size_t)rb * G * 32 + 2 * (size_t)C * rb * 32);",
            "constexpr int kRow = bwd_row<E, 3>();",
            "return bwd_cluster_smem_bytes<E, 3>(rb, H, C);",
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


def test_lstm_bwd_cluster_constants_match_the_source():
    """The LSTM backward's designs, read back from csrc/fused_lstm_bwd.cu
    and the cluster layer it includes: bwd_design repeats plan_bwd, the
    resident rows padded by one word, the step product and reduce-scatter
    the header's, shared with the GRU backward."""
    text = _cluster_text("fused_lstm_bwd.cu")
    assert _const(text, "kMaxSlices") == fused_lstm.MAX_SLICES
    assert _const(text, "kWarps") == fused_lstm.STREAM_WARPS
    for line in (
            "return G * kClusterUnits + 4 / (int)sizeof(E);",
            "constexpr int kRow = bwd_row<E, 4>();",
            "load_r_slice<E, 4, kRow>(Rs, R, H, HP, j0, nu);",
            "scatter_carry<E, 4, RB, kRow>(cluster, Rs, gp, slots, par, C, "
            "rank, H,",
            "gather_carry<RB>(slots, par ^ 1, C, gr, lane)",
            "return bwd_cluster_smem_bytes<E, 4>(rb, H, C);",
            "lstm_bwd_cluster_kernel<E, decltype(r)::value>, C, smem, n);",
            "while (rb > 1 && smem_bytes(rb, H, 1) > kSmemCap) rb /= 2;",
            "while (slices < kMaxSlices && tiles * slices < kWarps &&",
            "4 * H >= 16 * slices * 2 &&"):
        assert " ".join(line.split()) in " ".join(text.split()), line
    gru = (CSRC / "fused_gru_bwd.cu").read_text()
    assert "scatter_carry<E, 3, RB, kRow>(" in gru
    # H=256, 8 rows, a cluster of 8, f32: 256 rows of 129 words of R, the
    # operands 8 x 128 and the slots 2 x 8 x 8 x 32; bf16 rows of 130
    assert fused_lstm.bwd_cluster_smem_bytes(8, 256, 8, 4) == 4 * (
        256 * 129 + 8 * 128 + 2 * 8 * 8 * 32)
    assert fused_lstm.bwd_cluster_smem_bytes(8, 256, 8, 2) == (
        2 * 256 * 130 + 4 * (8 * 128 + 2 * 8 * 8 * 32))
    # about 149 KB in f32 at H = 256 and 121 KB at H = 200
    assert fused_lstm.bwd_cluster_smem_bytes(8, 256, 8, 4) // 1024 == 149
    assert fused_lstm.bwd_cluster_smem_bytes(8, 200, 8, 4) // 1024 == 120


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


def _grid_text(source):
    """A grid kernel's source and the shared layers it includes."""
    text = (CSRC / source).read_text()
    assert '#include "recurrent_grid.cuh"' in text
    return text + (CSRC / "recurrent_grid.cuh").read_text()


def test_grid_layer_constants_match_the_header():
    """csrc/recurrent_grid.cuh's constants, sizes and planner, as the
    Python mirror (ops/cuda/recurrent_grid.py) repeats them, and the GRU
    launchers' use of them: the cluster design first, then the grid."""
    text = (CSRC / "recurrent_grid.cuh").read_text()
    assert _const(text, "kGridWarps") == rg.GRID_WARPS
    assert _const(text, "kGridSlots") == rg.GRID_SLOTS
    assert _const(text, "kLstmGridSlots") == rg.LSTM_GRID_SLOTS
    assert _const(text, "kGridStage") == rg.GRID_STAGE
    assert _const(text, "kGridStagePad") == rg.GRID_STAGE_PAD
    assert _const(text, "kGridOperandPad") == rg.GRID_OPERAND_PAD
    rows = re.search(r"constexpr int kGridRows\[\] = \{([\d, ]+)\};",
                     text).group(1)
    assert tuple(int(r) for r in rows.split(",")) == rg.GRID_ROWS
    rows = re.search(r"constexpr int kLstmGridRows\[\] = \{([\d, ]+)\};",
                     text).group(1)
    assert tuple(int(r) for r in rows.split(",")) == rg.LSTM_GRID_ROWS
    cap = re.search(r"constexpr size_t kGridSmemCap = (\d+) \* 1024;", text)
    assert int(cap.group(1)) * 1024 == rg.GRID_SMEM_CAP
    for line in (
            "grid_units(int e, int slots = kGridSlots) {",
            "return slots * 4 / e;",
            "int grid_hp(int H) { return (H + 15) & ~15; }",
            "return kGridStage + kGridStagePad * rows;",
            "constexpr int kGridStageFloats = kGridStage + kGridStagePad * "
            "32;",
            "template <int G, int S = kGridSlots>",
            "fwd_grid_row() { return G * S + 4; }",
            "return G * slots + (e == 2 ? 4 : 1);",
            "int slots = kGridSlots, int rows = 32) {",
            "return (size_t)grid_hp(H) * (G * slots + 4) * 4 +",
            "2 * sizeof(float) * grid_stage_floats(rows);",
            "return (size_t)grid_hp(H) * bwd_grid_row(G, e, slots) * 4 +",
            "sizeof(float) * (size_t)rb * (G * grid_units(e, slots) + "
            "kGridOperandPad);",
            "constexpr int UL = grid_units(sizeof(E), S);",
            "const int (&rows)[NR] = kGridRows) {",
            "const int ul = grid_units(e, slots);",
            "for (int rb : rows) {",
            "const int n0 = (H + ul - 1) / ul;",
            "const int U = (H + n0 - 1) / n0;",
            "const int n = (H + U - 1) / U;",
            "if (smem > kGridSmemCap) break;",
            "const int most = cap / n;",
            "if (most < 1) continue;",
            "const int need = (B + rb - 1) / rb;",
            "*plan = GridPlan{U, n, rb, std::min(need, most), smem};",
            "if (need <= most) break;",
            "attr->id = cudaLaunchAttributeCooperative;",
            "cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,",
            "cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, "
            "dev);"):
        assert " ".join(line.split()) in " ".join(text.split()), line
    for source, lines in (
            ("fused_gru.cu", (
                "[&](int) { return fwd_grid_smem_bytes(H, 3); },",
                "grid_resident(gru_fwd_grid_kernel<E, decltype(r)::value>,",
                "load_grid_r<E, 3, Row>(Rs, R, H, HP, j0, nu);",
                "int dl4j_gru_fwd_plan(int T, int B, int H, int bf16, long "
                "long* out) {",
                "? (long long)fwd_grid_workspace_bytes(plan.groups, B, H)")),
            ("fused_gru_bwd.cu", (
                "[&](int rb) { return bwd_grid_smem_bytes(rb, H, 3, "
                "sizeof(E)); },",
                "grid_resident(gru_bwd_grid_kernel<E, decltype(r)::value>,",
                "load_grid_r<E, 3, Row>(Rs, R, H, HP, j0, nu);",
                "int dl4j_gru_bwd_plan(int T, int B, int H, int bf16, long "
                "long* out) {",
                "? (long long)bwd_grid_workspace_bytes( plan.groups, plan.n, "
                "plan.rb, H)"))):
        code = _grid_text(source)
        for line in lines:
            assert " ".join(line.split()) in " ".join(code.split()), line
        own = (CSRC / source).read_text()
        assert own.index("plan_cluster(") < own.index("plan_grid(")
    # what other SMs wrote is read through L2 only
    fwd = (CSRC / "fused_gru.cu").read_text()
    grid_fwd = fwd[fwd.index("gru_fwd_grid_kernel("):]
    grid_fwd = grid_fwd[:grid_fwd.index("// " + "-" * 66 + " choice")]
    assert "grid_stage16(" in grid_fwd and "cp_async4(" not in grid_fwd
    assert "__ldg" not in grid_fwd and "ldg_f32" not in grid_fwd
    # H = 1024: 1024 rows of 52 words and two stages of 2048 floats and
    # 32 rows' padding (f32 and bf16 alike: a slot holds a bf16 pair); the
    # backward's rows of 49 words (f32) or 52 (bf16, 16-byte rows for
    # ldmatrix) and its operands, 32 rows x (3 gates x 16 units + 8) in
    # f32, 16 rows x (3 x 32 + 8) in bf16
    assert rg.fwd_grid_smem_bytes(1024, 3) == 1024 * 52 * 4 + 2 * 4 * (
        2048 + 8 * 32)
    assert rg.bwd_grid_smem_bytes(32, 1024, 3, 4) == (
        1024 * 49 * 4 + 4 * 32 * (3 * 16 + 8))
    assert rg.bwd_grid_smem_bytes(16, 1024, 3, 2) == (
        1024 * 52 * 4 + 4 * 16 * (3 * 32 + 8))
    assert rg.fwd_grid_smem_bytes(1024, 3) <= rg.GRID_SMEM_CAP
    # the GRU's instances keep 16 slots and 32-row stages
    assert rg.grid_units(4) == rg.grid_units(4, 16) == 16
    assert rg.grid_units(2) == 32
    assert rg.GRID_STAGE_FLOATS == rg.grid_stage_floats(32) == 2048 + 8 * 32


def test_a_change_to_the_grid_header_rebuilds_the_gru_libraries(
        tmp_path, monkeypatch):
    """The two GRU sources and the two LSTM sources include
    csrc/recurrent_grid.cuh, and a library's name hashes every header: an
    edited grid header gives each a new library (no stale build is
    loaded)."""
    import shutil

    from deeplearning4j_tpu_torch.ops.cuda import build

    shutil.copytree(CSRC, tmp_path / "csrc")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    sources = ("fused_gru.cu", "fused_gru_bwd.cu", "fused_lstm.cu",
               "fused_lstm_bwd.cu")
    for src in sources:
        assert '#include "recurrent_grid.cuh"' in (
            tmp_path / "csrc" / src).read_text()
    libs = [build.CudaLibrary(src, {}) for src in sources]
    before = [lib.library_path() for lib in libs]
    header = tmp_path / "csrc" / "recurrent_grid.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [lib.library_path() for lib in libs]
    assert all(a != b for a, b in zip(before, after))


_GRU_DESIGNS = {"fwd": fused_gru.fwd_design, "bwd": fused_gru.bwd_design}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("T,H,kind", [
    (64, 512, "cluster"), (64, 513, "grid"), (64, 640, "grid"),
    (5, 640, "grid"), (64, 768, "grid"), (16, 1000, "grid"),
    (64, 1024, "grid"), (1, 1024, "stream"), (1, 640, "stream")])
def test_grid_design_takes_what_no_cluster_holds(dtype, direction, T, H,
                                                 kind):
    """On the H100 (132 SMs, 16 clusters), T > 1 takes the cluster design
    up to H = 512 and the grid design past it; T == 1 the stream design at
    any width."""
    d = _GRU_DESIGNS[direction](T, 64, H, dtype, _slots(16), H100)
    assert d.kind == kind
    if kind == "grid":
        assert d.cluster is None and d.smem <= rg.GRID_SMEM_CAP


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype,B,H,plan", [
    # (units a CTA, CTAs a group, rows a group, groups)
    (F32, 64, 1024, (16, 64, 32, 2)), (F32, 8, 1024, (16, 64, 8, 1)),
    (F32, 3, 1024, (16, 64, 8, 1)), (BF16, 64, 1024, (32, 32, 16, 4)),
    (BF16, 8, 1024, (32, 32, 8, 1)), (BF16, 3, 1024, (32, 32, 8, 1)),
    (F32, 64, 1000, (16, 63, 32, 2)), (F32, 64, 640, (16, 40, 32, 2)),
    (BF16, 64, 640, (32, 20, 16, 4)), (F32, 64, 768, (16, 48, 32, 2)),
    (F32, 3, 640, (16, 40, 8, 1)),
    # H = 513: 33 CTAs of 16 units; the backward's 101 KB a CTA let two
    # CTAs share an SM, so 8 groups of 8 rows fit
    (F32, 64, 513, {"fwd": (16, 33, 16, 4), "bwd": (16, 33, 8, 8)}),
    # more rows than the card's groups hold at once: 32 rows, 2 groups,
    # each of which takes 4 passes
    (F32, 256, 1024, (16, 64, 32, 2))])
def test_grid_plan_units_rows_groups(direction, dtype, B, H, plan):
    """The grid plan on the H100: H split evenly over the fewest CTAs of
    at most 16 (f32) or 32 (bf16) units; rows a group the fewest of 8, 16,
    32 whose groups fit the card's 132 CTAs at once (two groups of 64 CTAs
    in f32 at H = 1024, four of 32 in bf16), or 32 rows in as many groups
    as fit; the shared memory as the launcher sizes it."""
    d = _GRU_DESIGNS[direction](16, B, H, dtype, _slots(16), H100)
    assert d.kind == "grid"
    if isinstance(plan, dict):
        plan = plan[direction]
    assert (d.units, d.ctas, d.rows, d.groups) == plan
    assert d.ctas * d.groups <= H100(d.rows, d.smem)
    assert (d.ctas - 1) * d.units < H <= d.ctas * d.units
    e = 2 if dtype == BF16 else 4
    assert d.smem == (rg.fwd_grid_smem_bytes(H, 3) if direction == "fwd"
                      else rg.bwd_grid_smem_bytes(d.rows, H, 3, e))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_a_width_the_card_cannot_hold_takes_the_stream_design(direction,
                                                              dtype):
    """A card too small for a row group (fewer SMs than CTAs a group) and
    a width whose resident rows overflow a CTA's shared memory take the
    stream design, decided before any launch: the forward keeps H rows of
    52 words beside two h stages (to H = 1024), the backward rows of 49
    words (f32; to H = 1168) or 52 (bf16; to H = 1088) beside its operands
    (at 8 rows; H rounded up to 16)."""
    design = _GRU_DESIGNS[direction]
    n = 64 if dtype == F32 else 32    # CTAs a group at H = 1024
    assert design(64, 64, 1024, dtype, _slots(16), _sms(n - 1)).kind == \
        "stream"
    one = design(64, 64, 1024, dtype, _slots(16), _sms(n))
    assert (one.kind, one.groups, one.rows) == ("grid", 1, 32)
    widest = max(h for h in range(1000, 1300)
                 if design(8, 8, h, dtype, _slots(16), H100).kind == "grid")
    want = {"fwd": 1024, "bwd": 1168 if dtype == F32 else 1088}[direction]
    assert widest == want
    over = design(8, 8, widest + 1, dtype, _slots(16), H100)
    assert over.kind == "stream"
    assert fused_gru.kernel_admits(8, widest + 1, dtype, True)


@pytest.mark.parametrize("kind", ["cluster", "grid", "stream"])
def test_the_grid_design_gets_its_workspace(monkeypatch, kind):
    """Both GRU wrappers ask the launcher's (cached) plan and pass the
    workspace it asks for (the grid design's: the barrier counters, then
    the h exchange or the partial carries), as many bytes as it reports;
    the other designs ask for none and get none."""
    launched = []
    monkeypatch.setattr(fused_gru, "launch",
                        lambda kernel, sym, dev, args: launched.append(args))
    T, B, H = 3, 5, 600
    plan = {"grid": (rc.Design("grid", None, 8, 1024, 16, 38, 1), 4096),
            "cluster": (rc.Design("cluster", 16, 4, 1024), 0),
            "stream": (rc.Design("stream", None, 4, 1024), 0)}[kind]
    bwd_plan = (plan[0], 2 * plan[1])
    monkeypatch.setattr(fused_gru, "_fwd_plan", lambda *a: plan)
    monkeypatch.setattr(fused_gru, "_bwd_plan", lambda *a: bwd_plan)
    on_card = lambda *s: torch.zeros(*s).as_subclass(_OnCardDevice)  # noqa
    fused_gru.fused_gru_recurrence(on_card(T, B, 3 * H), on_card(H, 3 * H),
                                   on_card(B, H))
    fused_gru.fused_gru_bwd_recurrence(on_card(4, T, B, H),
                                       on_card(H, 3 * H), on_card(B, H),
                                       on_card(T, B, H), on_card(T, B, H))
    (fwd, bwd) = launched
    if kind == "grid":
        assert fwd[6] is not None and fwd[7] == 4096
        assert bwd[8] is not None and bwd[9] == 8192
    else:
        assert (fwd[6], fwd[7], bwd[8], bwd[9]) == (None, 0, None, 0)
    assert fwd[8:] == (T, B, H) and bwd[10:] == (T, B, H)


def test_decode_asks_no_plan(monkeypatch):
    """A T == 1 forward (decode) always takes the stream design, which
    needs no workspace: the wrapper launches without asking the
    launcher's plan."""
    launched = []
    monkeypatch.setattr(fused_gru, "launch",
                        lambda kernel, sym, dev, args: launched.append(args))

    def asked(*a):
        raise AssertionError("decode asked the launcher's plan")

    monkeypatch.setattr(fused_gru, "_fwd_plan", asked)
    B, H = 8, 1024
    on_card = lambda *s: torch.zeros(*s).as_subclass(_OnCardDevice)  # noqa
    fused_gru.fused_gru_recurrence(on_card(1, B, 3 * H), on_card(H, 3 * H),
                                   on_card(B, H))
    (args,) = launched
    assert (args[6], args[7]) == (None, 0) and args[8:] == (1, B, H)


@pytest.mark.parametrize("kind,out", [
    ("stream", [0, 0, 8, 20480, 0, 0, 0, 0]),
    ("cluster", [1, 16, 4, 200000, 0, 0, 0, 0]),
    ("grid", [2, 0, 32, 207872, 16, 64, 2, 33554688])])
def test_launcher_plan_reads_the_plan_query(monkeypatch, kind, out):
    """``launcher_plan`` reads a GRU plan query's eight 64-bit outputs
    (kind, C, RB, shared memory, U, n, groups, workspace bytes) into a
    Design and the workspace; the grid fields and the workspace are the
    grid design's alone."""
    seen = {}

    def query(kernel, symbol, n_out, device, *args, ctype):
        seen.update(symbol=symbol, n_out=n_out, args=args, ctype=ctype)
        return list(out)

    monkeypatch.setattr(rc, "query", query)
    design, work = fused_gru.launcher_plan(fused_gru.FUSED_GRU_BWD,
                                           "dl4j_gru_bwd_plan", 64, 64, 1024,
                                           BF16)
    assert seen == {"symbol": "dl4j_gru_bwd_plan", "n_out": 8,
                    "args": (64, 64, 1024, 1), "ctype": ctypes.c_longlong}
    assert design.kind == kind and design.rows == out[2]
    assert design.smem == out[3]
    if kind == "grid":
        assert (design.cluster, design.units, design.ctas,
                design.groups) == (None, 16, 64, 2)
        assert work == out[7]
    else:
        assert (design.units, design.ctas, design.groups, work) == (
            None, None, None, 0)
        assert design.cluster == (16 if kind == "cluster" else None)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gru_fwd_design_boundary(dtype):
    """The cluster design takes T > 1 up to the H where a cluster of 16
    still gives a CTA at most 32 units, in f32 and in bf16; one unit more
    takes the grid design (R across the whole card), and T == 1 at any H
    the stream design."""
    ok = _slots(16)
    H = max(h for h in range(1, 2048)
            if fused_gru.fwd_design(64, 64, h, dtype, ok, H100).kind
            == "cluster")
    assert H == 512
    at = fused_gru.fwd_design(64, 64, H, dtype, ok, H100)
    over = fused_gru.fwd_design(64, 64, H + 1, dtype, ok, H100)
    assert (at.kind, at.cluster, over.kind, over.cluster) == (
        "cluster", 16, "grid", None)
    assert at.smem <= rc.CLUSTER_SMEM_CAP
    small = fused_gru.fwd_design(64, 64, 256, dtype, ok)
    assert (small.kind, small.cluster) == ("cluster", 8)
    assert fused_gru.fwd_design(64, 64, 257, dtype, ok).cluster == 16
    for h in (7, 256, 512, 1024):
        assert fused_gru.fwd_design(1, 8, h, dtype, ok).kind == "stream"
    # a card that holds no such cluster: the grid design, and where it
    # holds no row group of the grid either, the stream design
    none = lambda C, rows, smem: 0  # noqa: E731
    assert fused_gru.fwd_design(64, 64, 256, dtype, none, H100).kind == \
        "grid"
    assert fused_gru.fwd_design(64, 64, 256, dtype, none,
                                _sms(0)).kind == "stream"
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
    slices; T > 1 at H=1024 on a card that holds no grid row group: 32
    unit tiles, so one; the H100 takes the grid design there)."""
    assert fused_gru.fwd_design(64, 64, 1024, F32, _slots(16),
                                H100).kind == "grid"
    d = fused_gru.fwd_design(64, 64, 1024, F32, _slots(16), _sms(0))
    assert (d.kind, d.rows) == ("stream", 8)
    assert d.smem == 4 * (8 * 1024 + 8 * 1024 + 32 * 3 * 8 * 32)
    h = _max_h(fused_gru, 7, False)
    assert fused_gru.fwd_design(7, 64, h, F32, _slots(16),
                                H100).rows == 1
    assert fused_gru.fwd_design(1, 3, 256, BF16, _slots(16)) == rc.Design(
        "stream", None, 4, 4 * (4 * 256 + 4 * 32 + 16 * 3 * 4 * 32))
    # decode at H=40: each slice at least 16 long, so 2 slices
    assert fused_gru.fwd_design(1, 8, 40, F32, _slots(16)).smem == \
        fused_gru.stream_smem_bytes(8, 40, 32, 2)


@pytest.mark.parametrize("T", [1, 2, 64])
@pytest.mark.parametrize("backward", [False, True])
def test_gru_kernel_admits_what_it_did(T, backward):
    """The cluster and grid designs change no limit: kernel_admits takes
    exactly the stream launcher's shared-memory limits, written out here,
    and every shape the cluster or grid design takes is one the stream
    design takes."""
    def stream(H):
        upb = min(H, 32) if T == 1 else H
        tiles = -(-upb // 32)
        fwd = 4 * (H + upb + tiles * 3 * 32) <= 200 * 1024
        bwd = 4 * (4 * H + -(-H // 32) * 32) <= 200 * 1024
        return fwd and (not backward or bwd)

    for H in list(range(1, 600, 7)) + list(range(9000, 12500, 61)):
        for dt in (F32, BF16):
            assert fused_gru.kernel_admits(T, H, dt, backward) is stream(H)
            for design in (fused_gru.fwd_design, fused_gru.bwd_design):
                if design(T, 64, H, dt, _slots(16), H100).kind in (
                        "cluster", "grid"):
                    assert stream(H)


# the cluster designs of the GRU backward and the LSTM forward: where a
# cluster of 16 stops holding R, in f32 and bf16, and the rows a cluster
_CLUSTER_DESIGNS = {"gru_bwd": lambda *a: fused_gru.bwd_design(*a, H100),
                    "lstm_fwd": lambda *a: fused_lstm.fwd_design(*a, H100),
                    "lstm_bwd": lambda *a: fused_lstm.bwd_design(*a, H100)}
#: the design a T > 1 call takes past the cluster's width on the H100:
#: the grid design, the GRU's and the LSTM's alike
_PAST_CLUSTER = {"gru_bwd": "grid", "lstm_fwd": "grid", "lstm_bwd": "grid"}
#: a backward cluster CTA's shared memory by kernel: (rows, H, C, e)
_BWD_SMEM = {"gru_bwd": fused_gru.bwd_cluster_smem_bytes,
             "lstm_bwd": fused_lstm.bwd_cluster_smem_bytes}


@pytest.mark.parametrize("dtype,kernel,H_max", [
    (F32, "gru_bwd", 512), (BF16, "gru_bwd", 512),
    (F32, "lstm_fwd", 436), (BF16, "lstm_fwd", 512),
    (F32, "lstm_bwd", 440), (BF16, "lstm_bwd", 512)])
def test_cluster_design_boundary(dtype, kernel, H_max):
    """T > 1 takes the cluster design up to the H where a cluster of 16
    still holds R: the GRU backward's units run out first (32 a CTA at H
    = 512); the LSTM forward's and backward's R [H, 4H] in f32 fill a
    CTA's 227 KB first (at H = 436 and 440, one row a cluster; the
    backward's rows are padded by a word but hold no h), in bf16 their
    units run out at 512. One unit more and a card that holds no such
    cluster take the grid design; T == 1 at any H the stream design."""
    design = _CLUSTER_DESIGNS[kernel]
    ok = _slots(16)
    H = max(h for h in range(1, 1100)
            if design(64, 64, h, dtype, ok).kind == "cluster")
    assert H == H_max
    at, over = design(64, 64, H, dtype, ok), design(64, 64, H + 1, dtype, ok)
    assert (at.kind, at.cluster, over.kind, over.cluster) == (
        "cluster", 16, _PAST_CLUSTER[kernel], None)
    assert at.smem <= rc.CLUSTER_SMEM_CAP
    small = design(64, 64, 256, dtype, ok)
    assert (small.kind, small.cluster) == ("cluster", 8)
    assert design(64, 64, 257, dtype, ok).cluster == 16
    for h in (7, 200, 256, 512, 1024):
        assert design(1, 8, h, dtype, ok).kind == "stream"
    none = lambda C, rows, smem: 0  # noqa: E731
    assert design(64, 64, 256, dtype, none).kind == _PAST_CLUSTER[kernel]
    if dtype == F32 and kernel.startswith("lstm"):
        assert at.rows == 1
    if kernel in _BWD_SMEM:  # the receive slots grow with the cluster
        assert at.smem == _BWD_SMEM[kernel](
            at.rows, H, 16, 2 if dtype == BF16 else 4)


@pytest.mark.parametrize("kernel", ["gru_bwd", "lstm_fwd", "lstm_bwd"])
@pytest.mark.parametrize("slots,B,rows", [
    (16, 64, 4), (8, 64, 8), (15, 64, 8), (64, 64, 1), (16, 1, 1),
    (16, 3, 1), (2, 3, 2), (1, 3, 4), (1, 100, 8)])
def test_cluster_rows_from_the_card(kernel, slots, B, rows):
    """Rows a cluster, as the GRU forward's: the fewest that let every
    cluster be resident at one CTA an SM, at most 8 and at most B rounded
    up to a power of two; the shared memory of that many rows."""
    d = _CLUSTER_DESIGNS[kernel](64, B, 256, F32, _slots(slots))
    assert (d.kind, d.cluster, d.rows) == ("cluster", 8, rows)
    assert d.smem == (_BWD_SMEM[kernel](rows, 256, 8, 4)
                      if kernel in _BWD_SMEM
                      else fused_lstm.cluster_smem_bytes(rows, 256, 4))


def test_stream_designs_of_the_gru_bwd_and_lstm_fwd():
    """The stream designs' rows and shared memory repeat their launchers':
    the GRU backward at H=1024 on a card that holds no grid row group (8
    rows; 32 unit tiles, so one slice; the H100 takes the grid design
    there) and T = 1; the LSTM forward at decode (DECODE_UNITS units a
    block, one tile, 16 k-slices at H=256, each 16 long) and at H=1024 on
    a card that holds no grid row group (8 rows, 32 unit tiles, so one
    slice; the H100 takes the grid design there)."""
    ok = _slots(16)
    assert fused_gru.bwd_design(64, 64, 1024, F32, ok, H100).kind == "grid"
    assert fused_gru.bwd_design(64, 64, 1024, F32, ok, _sms(0)) == rc.Design(
        "stream", None, 8, 4 * (8 * 3 * 1024 + 8 * 1024 + 32 * 8 * 32))
    assert fused_gru.bwd_design(1, 8, 256, BF16, ok) == rc.Design(
        "stream", None, 8, 4 * (8 * 768 + 8 * 256 + 2 * 8 * 8 * 32))
    assert fused_lstm.fwd_design(1, 8, 256, F32, ok) == rc.Design(
        "stream", None, 8, 4 * (8 * 256 + 8 * 8 + 16 * 4 * 8 * 32))
    assert fused_lstm.fwd_design(1, 3, 5, BF16, ok) == rc.Design(
        "stream", None, 4, 4 * (4 * 5 + 4 * 5 + 4 * 4 * 32))
    assert fused_lstm.fwd_design(64, 64, 1024, F32, ok,
                                 H100).kind == "grid"
    assert fused_lstm.fwd_design(64, 64, 1024, F32, ok, _sms(0)) == \
        rc.Design("stream", None, 8,
                  4 * (8 * 1024 + 8 * 1024 + 32 * 4 * 8 * 32))
    h = _max_h(fused_lstm, 7, False)
    assert fused_lstm.fwd_design(7, 64, h, F32, ok, H100).rows == 1


def test_lstm_bwd_stream_design():
    """The LSTM backward's stream design repeats its launcher's rows and
    shared memory: T = 1 at any H (8 rows; 8 unit tiles at H = 256, so two
    slices of the 4H reduction), and, on a card that holds no grid row
    group (the H100 takes the grid design there), H = 1024 (32 unit
    tiles, one slice) and H = 441 in f32 / 513 in bf16, one unit past a
    cluster of 16 (14 and 17 unit tiles: two slices, one)."""
    ok, none = _slots(16), _sms(0)
    assert fused_lstm.bwd_design(1, 8, 256, F32, ok) == rc.Design(
        "stream", None, 8, 4 * (8 * 4 * 256 + 8 * 256 + 2 * 8 * 8 * 32))
    assert fused_lstm.bwd_design(64, 64, 1024, BF16, ok, none) == rc.Design(
        "stream", None, 8, 4 * (8 * 4 * 1024 + 8 * 1024 + 32 * 8 * 32))
    for dt, H, slices in ((F32, 441, 2), (BF16, 513, 1)):
        assert fused_lstm.bwd_design(6, 5, H, dt, ok, H100).kind == "grid"
        d = fused_lstm.bwd_design(6, 5, H, dt, ok, none)
        assert (d.kind, d.rows) == ("stream", 8)
        assert d.smem == fused_lstm.bwd_stream_smem_bytes(8, H, slices)
    # rows halved while one block's share exceeds the cap
    h = _max_h(fused_lstm, 7, True)
    assert fused_lstm.bwd_design(7, 64, h, F32, ok, H100).rows == 1
    assert fused_lstm.bwd_smem_bytes(h) <= fused_lstm.SMEM_CAP


class _OnCardDevice(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that a wrapper
    takes its kernel path up to the (stubbed) launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("family,planes,gates", [(fused_lstm, 5, 4),
                                                 (fused_gru, 4, 3)])
@pytest.mark.parametrize("kind", ["cluster", "stream"])
def test_the_backward_forms_r_transpose_only_for_the_stream_design(
        monkeypatch, family, planes, gates, kind):
    """The backward wrapper asks the launcher's (cached) plan and forms
    R^T only for the stream design; the cluster design reads R, and gets
    a null R^T."""
    launched = []
    monkeypatch.setattr(family, "launch",
                        lambda kernel, sym, dev, args: launched.append(args))
    design = rc.Design(kind, 8 if kind == "cluster" else None, 4, 1024)
    # the plan also reports its workspace (none but the grid's)
    monkeypatch.setattr(family, "_bwd_plan", lambda *a: (design, 0))
    T, B, H = 3, 2, 5
    on_card = lambda *s: torch.zeros(*s).as_subclass(_OnCardDevice)  # noqa
    R = on_card(H, gates * H)
    if family is fused_lstm:
        family.fused_lstm_bwd_recurrence(on_card(planes, T, B, H), R,
                                         on_card(B, H), on_card(T, B, H))
    else:
        family.fused_gru_bwd_recurrence(on_card(planes, T, B, H), R,
                                        on_card(B, H), on_card(T, B, H),
                                        on_card(T, B, H))
    (args,) = launched
    assert args[1] == R.data_ptr()
    if kind == "cluster":
        assert args[2] is None
    else:
        assert args[2] not in (None, R.data_ptr())


@pytest.mark.parametrize("T", [1, 2, 64])
@pytest.mark.parametrize("backward", [False, True])
def test_lstm_kernel_admits_what_it_did(T, backward):
    """The cluster and grid designs change no limit: kernel_admits takes
    exactly the stream launchers' shared-memory limits, written out here
    (a decode block holds DECODE_UNITS units), and every shape the
    cluster or grid design takes is one the stream design takes; so does
    the GRU backward's cluster or grid design."""
    def stream(H):
        upb = min(H, 8) if T == 1 else H
        fwd = 4 * (H + upb + -(-upb // 32) * 4 * 32) <= 200 * 1024
        bwd = 4 * (5 * H + -(-H // 32) * 32) <= 200 * 1024
        return fwd and (not backward or bwd)

    for H in list(range(1, 600, 7)) + list(range(8000, 9000, 17)) + list(
            range(51000, 51100, 3)):
        for dt in (F32, BF16):
            assert fused_lstm.kernel_admits(T, H, dt, backward) is stream(H)
            for design in (fused_lstm.fwd_design, fused_lstm.bwd_design):
                if design(T, 64, H, dt, _slots(16), H100).kind in (
                        "cluster", "grid"):
                    assert stream(H)
            if fused_gru.bwd_design(T, 64, H, dt, _slots(16),
                                    H100).kind in ("cluster", "grid"):
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


# ------------------------------------------------------------ LRN forward

def _lrn_fwd_text():
    """The LRN forward's source and the layout header it includes."""
    text = (CSRC / "lrn_fwd.cu").read_text()
    assert '#include "lrn_common.cuh"' in text
    return text + (CSRC / "lrn_common.cuh").read_text()


def test_lrn_layout_constants_match_the_sources():
    """``fwd_design`` repeats ``lrn::layout`` and ``lrn::vector_path``: 8
    channels a thread, whole rows in blocks of at most 256 threads, one
    row of up to 512 threads past 2048 channels, 16-byte vectors where C
    is a multiple of the vector and the pointers are aligned."""
    text = _lrn_fwd_text()
    assert _const(text, "kSeg") == lrn.SEG
    assert _const(text, "kThreads") == lrn.THREADS
    assert _const(text, "kMaxChannels") == lrn.MAX_CHANNELS
    assert _const(text, "kMaxThreads") * lrn.SEG == lrn.MAX_CHANNELS
    for line in ("const int tpr = (C + kSeg - 1) / kSeg;",
                 "return {tpr, tpr <= kThreads ? kThreads / tpr : 1};",
                 "constexpr int V = 16 / sizeof(T);",
                 "return C % V == 0 && (pointers & 15) == 0;",
                 "const Layout L = layout(C);",
                 "lrn_fwd_kernel<T, Vec, 5><<<(unsigned)blocks, L.P * L.tpr",
                 "const uintptr_t pointers = aligned ? 0 : 1;"):
        assert line in text, line


# (C, aligned, dtype, (path, rows a block, threads a row)) at the layout's
# boundaries: C = 8k and 8k + 1, the vector's multiple for f32 (4) and
# bf16 (8), one row a block from 2048 channels on, the largest C
LRN_DESIGNS = [
    (96, True, F32, ("vector", 21, 12)),      # AlexNet conv1
    (96, False, F32, ("element", 21, 12)),
    (256, True, BF16, ("vector", 8, 32)),     # AlexNet conv2
    (256, False, BF16, ("element", 8, 32)),
    (257, True, F32, ("element", 7, 33)),
    (8, True, BF16, ("vector", 256, 1)),
    (9, True, F32, ("element", 128, 2)),
    (4, True, F32, ("vector", 256, 1)),
    (4, True, BF16, ("element", 256, 1)),
    (12, True, BF16, ("element", 128, 2)),
    (77, True, F32, ("element", 25, 10)),
    (3, True, F32, ("element", 256, 1)),
    (2048, True, F32, ("vector", 1, 256)),
    (2049, True, F32, ("element", 1, 257)),
    (4096, True, BF16, ("vector", 1, 512)),
    (4096, False, F32, ("element", 1, 512)),
]


@pytest.mark.parametrize("C,aligned,dtype,want", LRN_DESIGNS)
def test_lrn_fwd_design_boundary(C, aligned, dtype, want):
    path, rows, tpr = lrn.fwd_design(C, aligned, dtype)
    assert (path, rows, tpr) == want
    assert rows * tpr <= 2 * lrn.THREADS and tpr * lrn.SEG >= C


@pytest.mark.parametrize("C", [0, 4097])
def test_lrn_fwd_design_refuses_what_the_kernel_refuses(C):
    with pytest.raises(ValueError, match="outside"):
        lrn.fwd_design(C, True)


@pytest.mark.parametrize("depth", [5, 4])
@pytest.mark.parametrize("C,ok", [(4096, True), (4097, False), (1, True)])
def test_lrn_requires_at_the_channel_limit(depth, C, ok):
    """Depth 5 (the unrolled window) and 4 (the run-time one) take the
    same layout and the same limits."""
    for dt in (F32, BF16):
        assert lrn._cuda_requires(_t(3, 2, C, dtype=dt), depth=depth) is ok
    assert not lrn._cuda_requires(_t(3, 2, 96, dtype=torch.float16),
                                  depth=depth)


@pytest.mark.parametrize("out,want", [([1, 21, 12], ("vector", 21, 12)),
                                      ([0, 1, 257], ("element", 1, 257))])
def test_lrn_launcher_design_reads_the_plan_query(monkeypatch, out, want):
    seen = {}

    def query(kernel, symbol, n_out, device, *args):
        seen.update(kernel=kernel, symbol=symbol, n_out=n_out, args=args)
        return list(out)

    monkeypatch.setattr(rc, "query", query)
    assert lrn.launcher_design(96, False, BF16) == want
    assert seen == {"kernel": lrn.LRN_FWD, "symbol": "dl4j_lrn_fwd_plan",
                    "n_out": 3, "args": (96, 0, 1)}


# ------------------------------------------------- the LSTM's grid design


def test_lstm_grid_constants_match_the_sources():
    """The LSTM launchers on the grid layer, read back from
    csrc/fused_lstm.cu and csrc/fused_lstm_bwd.cu: the cluster design
    first, then the grid at the LSTM's slots and rows, then the stream
    design; four gates at 8 slots, the shared memory of each as the Python
    mirror sizes it; and what other SMs wrote read through L2 only."""
    for source, lines in (
            ("fused_lstm.cu", (
                "return fwd_grid_smem_bytes(H, 4, kLstmGridSlots, 64);",
                "[&](int) { return lstm_fwd_grid_smem_bytes(H); },",
                "grid_resident(lstm_fwd_grid_kernel<E, decltype(r)::value>,",
                "&gp, kLstmGridSlots, kLstmGridRows);",
                "load_grid_r<E, 4, Row, S>(Rs, R, H, HP, j0, nu);",
                "constexpr int S = kLstmGridSlots;",
                "constexpr int SF = grid_stage_floats(64);",
                "int dl4j_lstm_fwd_plan(int T, int B, int H, int bf16, long "
                "long* out) {",
                "? (long long)fwd_grid_workspace_bytes(plan.groups, B, H)",
                "int dl4j_lstm_grid_resident(int bf16, int rb, int smem, "
                "int* n) {")),
            ("fused_lstm_bwd.cu", (
                "return bwd_grid_smem_bytes(rb, H, 4, sizeof(E), "
                "kLstmGridSlots);",
                "grid_resident(lstm_bwd_grid_kernel<E, decltype(r)::value>,",
                "return by_grid_rows(rb, [&](auto r) {",
                "&gp, kLstmGridSlots);",
                "load_grid_r<E, 4, Row, S>(Rs, R, H, HP, j0, nu);",
                "constexpr int Row = bwd_grid_row(4, sizeof(E), S) * 4 / "
                "(int)sizeof(E);",
                "int dl4j_lstm_bwd_plan(int T, int B, int H, int bf16, long "
                "long* out) {",
                "? (long long)bwd_grid_workspace_bytes( plan.groups, plan.n, "
                "plan.rb, H)",
                "int dl4j_lstm_bwd_grid_resident(int bf16, int rb, int "
                "smem, int* n) {"))):
        code = _grid_text(source)
        flat = " ".join(code.split())
        for line in lines:
            assert " ".join(line.split()) in flat, (source, line)
        own = (CSRC / source).read_text()
        plan = own[own.index("cudaError_t plan_"):]
        # cluster, then grid, then the stream design's rows
        assert (plan.index("plan_cluster(") < plan.index("plan_grid(")
                < plan.index("while (rb < 8 && rb < B) rb *= 2;"))
        assert "kGrid, 0, gp.rb" in plan and "kCluster, cp.C" in plan
        kernel = own[own.index("_grid_kernel(const"):]
        kernel = kernel[:kernel.index("// " + "-" * 66 + " choice")]
        assert "__ldg" not in kernel and "ldg_f32" not in kernel
        assert "cp_async4(" not in kernel
        assert ("grid_stage16(" in kernel if source == "fused_lstm.cu"
                else "ld_cg_f32(" in kernel)
    # H = 1024, four gates at 8 slots: rows of 36 words and two stages of
    # 2048 floats and 64 rows' padding; the backward's rows of 33 words
    # (f32) or 36 (bf16) and its operands, 32 rows x (4 x 8 + 8) in f32,
    # 32 rows x (4 x 16 + 8) in bf16. The GRU's three gates keep 16 slots.
    assert fused_lstm.grid_smem_bytes(1024) == 1024 * 36 * 4 + 2 * 4 * (
        2048 + 8 * 64) == 167936
    assert fused_lstm.bwd_grid_smem_bytes(32, 1024, 4) == (
        1024 * 33 * 4 + 4 * 32 * (4 * 8 + 8)) == 140288
    assert fused_lstm.bwd_grid_smem_bytes(32, 1024, 2) == (
        1024 * 36 * 4 + 4 * 32 * (4 * 16 + 8)) == 156672
    assert rg.grid_units(4, rg.LSTM_GRID_SLOTS) == 8
    assert rg.grid_units(2, rg.LSTM_GRID_SLOTS) == 16
    assert rg.fwd_grid_smem_bytes(1024, 3) == rg.fwd_grid_smem_bytes(
        1024, 3, 16, 32) == 1024 * 52 * 4 + 2 * 4 * (2048 + 8 * 32)
    assert rg.bwd_grid_smem_bytes(32, 1024, 3, 4) == rg.bwd_grid_smem_bytes(
        32, 1024, 3, 4, 16)
    # 16 slots with four gates would not fit at H = 1024; 8 leave room
    assert rg.fwd_grid_smem_bytes(1024, 4, 16) > rg.GRID_SMEM_CAP
    assert fused_lstm.grid_smem_bytes(1024) <= rg.GRID_SMEM_CAP


_LSTM_DESIGNS = {"fwd": fused_lstm.fwd_design, "bwd": fused_lstm.bwd_design}


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_lstm_grid_design_boundaries(direction, dtype):
    """On the H100 (132 SMs, 16 clusters), at T > 1: the cluster design to
    its last width (f32 forward 436, backward 440; bf16 512), the grid
    design from the next (437, 441, 513) through H = 650 and 1024, and
    the stream design from the first width past the grid: in f32 a row
    group of 8-unit CTAs outgrows the 132 SMs past H = 1056; in bf16 a
    CTA's R outgrows its shared memory past H = 1472 forward and 1584
    backward. Decode (T == 1) takes the stream design at every width."""
    design = _LSTM_DESIGNS[direction]
    ok = _slots(16)
    last = {F32: {"fwd": 436, "bwd": 440}[direction], BF16: 512}[dtype]
    past = {F32: 1057, BF16: {"fwd": 1473, "bwd": 1585}[direction]}[dtype]
    assert design(64, 64, last, dtype, ok, H100).kind == "cluster"
    for H in (last + 1, 650, 1024, past - 1):
        d = design(64, 64, H, dtype, ok, H100)
        assert d.kind == "grid" and d.cluster is None, H
        assert d.smem <= rg.GRID_SMEM_CAP
        assert d.ctas * d.groups <= H100(d.rows, d.smem)
        assert (d.ctas - 1) * d.units < H <= d.ctas * d.units
    assert design(64, 64, past, dtype, ok, H100).kind == "stream"
    assert design(8, 8, past, dtype, ok, H100).kind == "stream"
    assert fused_lstm.kernel_admits(64, past, dtype, True)
    for H in (256, 650, 1024, 2048):
        assert design(1, 8, H, dtype, ok, H100).kind == "stream"


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype,B,H,plan", [
    # (units a CTA, CTAs a group, rows a group, groups); the backward's
    # groups take at most 32 rows
    (F32, 64, 1024, {"fwd": (8, 128, 64, 1), "bwd": (8, 128, 32, 1)}),
    (BF16, 64, 1024, (16, 64, 32, 2)),
    (F32, 8, 1024, (8, 128, 8, 1)), (BF16, 3, 1024, (16, 64, 8, 1)),
    # the ragged width: 650 is no multiple of 8 or 16, and 50 rows no
    # multiple of a group's
    (F32, 50, 650, (8, 82, 32, 2)), (BF16, 50, 650, (16, 41, 16, 4)),
    (F32, 8, 650, (8, 82, 8, 1)),
    (F32, 64, 448, (8, 56, 16, 4)),
    # more rows than the card's groups hold at once: one group, which
    # takes 4 passes of 64 rows (the backward 8 of 32)
    (F32, 256, 1024, {"fwd": (8, 128, 64, 1), "bwd": (8, 128, 32, 1)})])
def test_lstm_grid_plan_units_rows_groups(direction, dtype, B, H, plan):
    """The LSTM grid plan on the H100: H split evenly over the fewest CTAs
    of at most 8 (f32) or 16 (bf16) units; rows a group the fewest of 8,
    16, 32, 64 (the backward: 8, 16, 32) whose groups fit the card's CTAs
    at once (one group of 128 CTAs in f32 at H = 1024, two of 64 in bf16),
    or the most rows in as many groups as fit; the shared memory as the
    launcher sizes it."""
    d = _LSTM_DESIGNS[direction](16, B, H, dtype, _slots(16), H100)
    assert d.kind == "grid"
    if isinstance(plan, dict):
        plan = plan[direction]
    assert (d.units, d.ctas, d.rows, d.groups) == plan
    assert d.ctas * d.groups <= H100(d.rows, d.smem)
    e = 2 if dtype == BF16 else 4
    assert d.smem == (fused_lstm.grid_smem_bytes(H) if direction == "fwd"
                      else fused_lstm.bwd_grid_smem_bytes(d.rows, H, e))


@pytest.mark.parametrize("kind", ["cluster", "grid", "stream"])
def test_the_lstm_grid_design_gets_its_workspace(monkeypatch, kind):
    """Both LSTM wrappers ask the launcher's (cached) plan and pass the
    workspace it asks for (the grid design's: the barrier counters, then
    the h exchange or the partial carries), as many bytes as it reports;
    the other designs ask for none and get none. The backward forms R^T
    only for the stream design."""
    launched = []
    monkeypatch.setattr(fused_lstm, "launch",
                        lambda kernel, sym, dev, args: launched.append(args))
    T, B, H = 3, 5, 600
    plan = {"grid": (rc.Design("grid", None, 8, 1024, 8, 75, 1), 4096),
            "cluster": (rc.Design("cluster", 16, 4, 1024), 0),
            "stream": (rc.Design("stream", None, 4, 1024), 0)}[kind]
    bwd_plan = (plan[0], 2 * plan[1])
    monkeypatch.setattr(fused_lstm, "_fwd_plan", lambda *a: plan)
    monkeypatch.setattr(fused_lstm, "_bwd_plan", lambda *a: bwd_plan)
    on_card = lambda *s: torch.zeros(*s).as_subclass(_OnCardDevice)  # noqa
    R = on_card(H, 4 * H)
    fused_lstm.fused_lstm_recurrence(on_card(T, B, 4 * H), R, on_card(B, H),
                                     on_card(B, H))
    fused_lstm.fused_lstm_bwd_recurrence(on_card(5, T, B, H), R,
                                         on_card(B, H), on_card(T, B, H))
    (fwd, bwd) = launched
    if kind == "grid":
        assert fwd[9] is not None and fwd[10] == 4096
        assert bwd[9] is not None and bwd[10] == 8192
    else:
        assert (fwd[9], fwd[10], bwd[9], bwd[10]) == (None, 0, None, 0)
    assert fwd[11:] == (T, B, H) and bwd[11:] == (T, B, H)
    assert bwd[1] == R.data_ptr()
    assert (bwd[2] is None) is (kind != "stream")


def test_lstm_decode_asks_no_plan(monkeypatch):
    """A T == 1 LSTM forward (decode) always takes the stream design,
    which needs no workspace: the wrapper launches without asking the
    launcher's plan."""
    launched = []
    monkeypatch.setattr(fused_lstm, "launch",
                        lambda kernel, sym, dev, args: launched.append(args))

    def asked(*a):
        raise AssertionError("decode asked the launcher's plan")

    monkeypatch.setattr(fused_lstm, "_fwd_plan", asked)
    B, H = 8, 1024
    on_card = lambda *s: torch.zeros(*s).as_subclass(_OnCardDevice)  # noqa
    fused_lstm.fused_lstm_recurrence(on_card(1, B, 4 * H), on_card(H, 4 * H),
                                     on_card(B, H), on_card(B, H))
    (args,) = launched
    assert (args[9], args[10]) == (None, 0) and args[11:] == (1, B, H)


@pytest.mark.parametrize("symbol", ["dl4j_lstm_fwd_plan",
                                    "dl4j_lstm_bwd_plan"])
def test_lstm_launcher_design_reads_the_plan_query(monkeypatch, symbol):
    """The LSTM launchers' plan queries write the GRU's eight 64-bit
    outputs; ``launcher_design`` / ``launcher_bwd_design`` read the grid
    fields from them."""
    seen = {}

    def query(kernel, sym, n_out, device, *args, ctype):
        seen.update(symbol=sym, n_out=n_out, args=args, ctype=ctype)
        return [2, 0, 64, 167936, 8, 128, 1, 1234]

    monkeypatch.setattr(rc, "query", query)
    fn = (fused_lstm.launcher_design if symbol == "dl4j_lstm_fwd_plan"
          else fused_lstm.launcher_bwd_design)
    design = fn(64, 64, 1024, F32)
    assert seen == {"symbol": symbol, "n_out": 8, "args": (64, 64, 1024, 0),
                    "ctype": ctypes.c_longlong}
    assert design == rc.Design("grid", None, 64, 167936, 8, 128, 1)
    # each launcher takes the workspace and its bytes before T, B, H
    want = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    for kernel in (fused_lstm.FUSED_LSTM, fused_lstm.FUSED_LSTM_BWD):
        for sym in ("dl4j_lstm_fwd", "dl4j_lstm_fwd_bf16", "dl4j_lstm_bwd",
                    "dl4j_lstm_bwd_bf16"):
            if sym in kernel.library.functions:
                assert list(kernel.library.functions[sym][0]) == want
