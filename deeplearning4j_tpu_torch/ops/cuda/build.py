"""Build a hand-written CUDA source into a shared library and load it.

Route (b) of the port's kernel rules: each ``csrc/*.cu`` file exposes a
plain C interface, is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library at first use (never at import), and is called through
``ctypes`` with raw device pointers and PyTorch's current stream. No
PyTorch headers are compiled, so a build takes seconds.

Libraries go into ``deeplearning4j_tpu_torch/_build/`` (listed in
``.gitignore``), or the directory ``DL4J_TORCH_COMPILE_CACHE`` or
``monitoring.compile.configure_compile_cache`` names, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source rebuilds and an unchanged one loads the cached library.
With monitoring on, each build counts in ``dl4j_compiles_total`` and
``dl4j_compile_seconds`` and each probe of the directory in
``dl4j_compile_cache_events_total`` (``monitoring/compile.py``).

:class:`CudaKernel` pairs a library with its launch count, and
:func:`launch` calls one of its C launchers on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from deeplearning4j_tpu_torch.common.env import env
from deeplearning4j_tpu_torch.monitoring import compile as compile_metrics

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = (Path(env.compile_cache_dir) if env.compile_cache_dir
             else PACKAGE_DIR / "_build")
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """The CUDA compiler of the toolkit PyTorch finds ($CUDA_HOME, nvcc on
    PATH, or the default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME); the hand-written "
                       "kernels are compiled on the machine with the card")


def check_device(device: torch.device) -> None:
    """The libraries hold sm_90a code only: refuse any other card."""
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"kernels are built for {ARCH} (Hopper); "
            f"{torch.cuda.get_device_name(device)} is sm_{major}{minor}")


def hashed_library_path(stem: str, sources, flags) -> Path:
    """``BUILD_DIR/<stem>-<hash>.so``, the hash over the sources' bytes and
    the flags: an edited source or flag builds anew, an unchanged one
    finds its library."""
    digest = hashlib.sha1()
    for src in sources:
        digest.update(Path(src).read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:12]}.so"


def compile_library(command, path: Path, timeout=None):
    """Run ``command(out)`` to build into a temporary file beside ``path``
    and publish it there with ``os.replace`` when the compiler succeeds:
    processes that build the same library at once each publish a whole
    one. Returns (the finished process, seconds)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(command(tmp), capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode == 0:
            os.replace(tmp, path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc, time.perf_counter() - t0


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, built once per process and loaded.

    ``functions`` maps each exported C symbol to ``(argtypes, restype)``.
    After :meth:`load`, ``build_seconds`` holds the compile time of this
    process (0.0 when a cached library was loaded) and ``build_log`` the
    compiler's ``-Xptxas -v`` report."""

    def __init__(self, source: str, functions: dict):
        self.source = CSRC_DIR / source
        self.functions = functions
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._checked: set = set()  # device indices found to be sm_90
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        return hashed_library_path(
            self.source.stem,
            [self.source, *sorted(CSRC_DIR.glob("*.cuh"))], NVCC_FLAGS)

    def build(self) -> Path:
        """Compile the source unless this exact build already exists."""
        path = self.library_path()
        if path.exists():
            self.build_seconds = 0.0
            compile_metrics.record_cache("hit")
            return path
        proc, self.build_seconds = compile_library(
            lambda out: [find_nvcc(), *NVCC_FLAGS, "-o", out,
                         str(self.source)], path)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        self.build_log = proc.stdout + proc.stderr
        compile_metrics.record_build(self.build_seconds)
        return path

    def sass(self) -> dict:
        """The built library's machine code by device function, as
        ``cuobjdump -sass`` (beside nvcc) prints it: {mangled name: text}."""
        tool = Path(find_nvcc()).with_name("cuobjdump")
        path = self.library_path() if self._lib is not None else self.build()
        proc = subprocess.run([str(tool), "-sass", str(path)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump failed on {self.source.name}:\n"
                               f"{proc.stderr}")
        out, name = {}, None
        for line in proc.stdout.splitlines():
            if line.strip().startswith("Function :"):
                name = line.split(":", 1)[1].strip()
                out[name] = ""
            elif name is not None:
                out[name] += line + "\n"
        return out

    def load(self, device: Optional[torch.device] = None) -> ctypes.CDLL:
        """The loaded library, built at first use; with ``device``, also
        checks once that the card is sm_90."""
        if self._lib is not None and (device is None
                                      or device.index in self._checked):
            return self._lib
        with self._lock:
            if device is not None and device.index not in self._checked:
                check_device(device)
                self._checked.add(device.index)
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for sym, (argtypes, restype) in self.functions.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = list(argtypes)
                    fn.restype = restype
                self._lib = lib
            return self._lib


def tensor_core_ops(library: CudaLibrary, function: str,
                    operand: str = "") -> dict:
    """How many tensor-core instructions the device functions whose name
    holds ``function`` compiled to: {"HGMMA": n (wgmma), "HMMA": n
    (mma.sync)}; with ``operand`` (e.g. "TF32"), only those whose
    modifiers name it (``HMMA.1684.F32.TF32``)."""
    codes = [text for name, text in library.sass().items()
             if function in name]
    if not codes:
        raise RuntimeError(f"no device function {function!r} in "
                           f"{library.source.name}")
    mods = rf"[\w.]*\.{operand}\b" if operand else ""
    return {op: sum(len(re.findall(rf"\b{op}\.{mods}", t)) for t in codes)
            for op in ("HGMMA", "HMMA")}


def pointer(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C launcher."""
    if status != 0:
        msg = lib.dl4j_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg})")


def c_args(kinds: str) -> Sequence:
    """ctypes argtypes, one letter each: 'p' pointer or stream, 'i' int,
    'l' long long, 'f' float."""
    table = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
             "f": ctypes.c_float}
    return [table[k] for k in kinds]


class CudaKernel:
    """One kernel: its source's built library and its launch count.

    ``symbols`` maps each C launcher to its argument kinds (:func:`c_args`);
    every launcher returns a ``cudaError_t``, and every source exports
    ``dl4j_cuda_error_string``."""

    def __init__(self, name, source, replaces, symbols):
        self.name = name
        self.source = f"deeplearning4j_tpu_torch/csrc/{source}"
        self.replaces = replaces
        self.library = CudaLibrary(source, {
            **{sym: (c_args(kinds), ctypes.c_int)
               for sym, kinds in symbols.items()},
            "dl4j_cuda_error_string": (c_args("i"), ctypes.c_char_p),
        })
        self.launches = 0


def launch(kernel: CudaKernel, symbol: str, device: torch.device, args):
    """Call ``symbol`` of ``kernel``'s library with ``args`` and PyTorch's
    current stream on ``device``; raise on a non-zero status, count the
    launch."""
    lib = kernel.library.load(device)
    fn = getattr(lib, symbol)
    if device.index == torch.cuda.current_device():
        status = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:  # the C launcher uses the calling thread's current device
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_status(lib, status, symbol)
    kernel.launches += 1
