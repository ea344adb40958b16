"""Package rules of the port: no JAX, lazy kernels, the card by default.

The port (deeplearning4j_tpu_torch) and chip_smoke.py import neither jax
nor anything of the JAX package; importing builds no kernel; entry points
default to device="cuda" and raise where there is no card; chip_smoke.py
fails without a card and outside a checkout.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "deeplearning4j_tpu_torch"


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeplearning4j_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'deeplearning4j_tpu' "
        "or m.startswith('deeplearning4j_tpu.')]\n"
        "assert not bad, bad\n"
        "from deeplearning4j_tpu_torch.ops.cuda import KERNELS\n"
        "assert all(k.library._lib is None for k in KERNELS), 'built at import'\n"
        "print(' '.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 27
    assert {f"deeplearning4j_tpu_torch.{m}" for m in (
        "ops.losses", "ops.cuda.fused_lstm", "optimize.schedules",
        "optimize.updaters", "nn.multilayer", "util.serialization",
        "quantize.kvcache", "serving.warmup", "generation.sessions")} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_statement(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "deeplearning4j_tpu"), (path, n)


def test_every_jax_module_has_a_counterpart():
    """Each module of the JAX package has one at the same relative path in
    the port, but the Pallas kernels (the port's are ``ops/cuda/`` and
    ``csrc/``) and ``parallel/_compat.py`` (``parallel/collectives.py``)."""
    jax_pkg = ROOT / "deeplearning4j_tpu"
    theirs = {p.relative_to(jax_pkg).as_posix() for p in jax_pkg.rglob("*.py")}
    ours = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert sorted(theirs - ours) == [
        "ops/pallas/__init__.py", "ops/pallas/flash_attention.py",
        "ops/pallas/fused_gru.py", "ops/pallas/fused_lstm.py",
        "ops/pallas/lrn.py", "parallel/_compat.py"]
    assert (PKG / "parallel" / "collectives.py").is_file()


@pytest.mark.parametrize("path", sorted(ROOT.glob("tests/test_torch_*.py")),
                         ids=lambda p: p.name)
def test_port_tests_carry_no_xfail(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.Attribute)
                    and node.attr == "xfail"), (path, node.lineno)


def test_kernel_sources_are_in_the_package():
    from deeplearning4j_tpu_torch.ops.cuda import KERNELS

    ignored = (ROOT / ".gitignore").read_text().split()
    assert "deeplearning4j_tpu_torch/_build/" in ignored
    for k in KERNELS:
        assert (ROOT / k.source).is_file()
        assert k.library.source == ROOT / k.source
        lib = k.library.library_path()
        assert lib.parent == PKG / "_build" and lib.suffix == ".so"


def test_entry_points_default_to_the_card(tmp_path):
    from deeplearning4j_tpu_torch.common.device import resolve_device
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    model = TextGenerationLSTM(units=4, vocab_size=3)
    if torch.cuda.is_available():
        assert model.init().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="is_available"):
        model.init()
    net = model.init(device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        GenerationEngine(net, slots=1)
    assert GenerationEngine(net, slots=1, device="cpu").generate(
        [0, 1], max_new_tokens=2) is not None


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "is_available" in proc.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
