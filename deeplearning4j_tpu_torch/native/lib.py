"""Build and load the native library (ctypes over native/dl4jtpu_native.cpp).

Counterpart of ``deeplearning4j_tpu/native/lib.py``. The source is the
repo's own ``native/dl4jtpu_native.cpp``; ``g++`` builds it at first use
into the port's build directory (``deeplearning4j_tpu_torch/_build/``,
where the CUDA kernels go) under a name hashed from the source and the
flags, published with ``os.replace`` (``ops/cuda/build.py``), so workers
that build at once agree. Two attempts, as in the JAX package: with the
JPEG/PNG decode front (``-DDL4J_WITH_CODECS -ljpeg -lpng``), then without
it on a host that lacks the codec dev files.

On a host with no compiler the committed portable
``native/build/libdl4jtpu.so`` loads instead (read, never written);
``native_library_path`` says which library a process loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "dl4jtpu_native.cpp"
# committed PORTABLE artifact: codec-free, no shared-library dependencies
# beyond libc/libstdc++ — the fallback for toolchain-less hosts
_SO = _ROOT / "native" / "build" / "libdl4jtpu.so"
_BASE_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
# the decode front first; the codec-less build where libjpeg/libpng's dev
# files are missing (the Python layer then decodes via PIL)
_ATTEMPTS = (("-DDL4J_WITH_CODECS", "-ljpeg", "-lpng"), ())

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_loaded: Optional[Path] = None
_tried = False


def built_library_paths():
    """Where each build attempt puts its library, in load order."""
    from deeplearning4j_tpu_torch.ops.cuda.build import hashed_library_path

    return [hashed_library_path("libdl4jtpu", [_SRC], _BASE_FLAGS + extra)
            for extra in _ATTEMPTS]


def _build() -> Optional[Path]:
    """Build the first variant this host can compile; its path, or None."""
    from deeplearning4j_tpu_torch.ops.cuda.build import compile_library

    err = ""
    for path, extra in zip(built_library_paths(), _ATTEMPTS):
        try:
            proc, _ = compile_library(
                lambda out, extra=extra: ["g++", *_BASE_FLAGS, "-o", out,
                                          str(_SRC), *extra], path,
                timeout=300)
        except (OSError, subprocess.TimeoutExpired):  # no g++, or hung
            return None
        if proc.returncode == 0:
            return path
        err = proc.stderr
    warnings.warn(f"native build failed:\n{err[-2000:]}")
    return None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.dl4j_ws_create.restype = c.c_void_p
    lib.dl4j_ws_create.argtypes = [c.c_size_t]
    lib.dl4j_ws_alloc.restype = c.c_void_p
    lib.dl4j_ws_alloc.argtypes = [c.c_void_p, c.c_size_t, c.c_size_t]
    lib.dl4j_ws_reset.argtypes = [c.c_void_p]
    lib.dl4j_ws_used.restype = c.c_size_t
    lib.dl4j_ws_used.argtypes = [c.c_void_p]
    lib.dl4j_ws_peak.restype = c.c_size_t
    lib.dl4j_ws_peak.argtypes = [c.c_void_p]
    lib.dl4j_ws_spilled.restype = c.c_size_t
    lib.dl4j_ws_spilled.argtypes = [c.c_void_p]
    lib.dl4j_ws_destroy.argtypes = [c.c_void_p]

    lib.dl4j_pipe_create.restype = c.c_void_p
    lib.dl4j_pipe_create.argtypes = [c.c_char_p, c.c_char_p, c.c_long,
                                     c.c_long, c.c_long, c.c_long, c.c_int,
                                     c.c_uint, c.c_int, c.c_int]
    lib.dl4j_pipe_next.restype = c.c_int
    lib.dl4j_pipe_next.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                   c.POINTER(c.c_float)]
    lib.dl4j_pipe_reset.argtypes = [c.c_void_p]
    lib.dl4j_pipe_batches_per_epoch.restype = c.c_long
    lib.dl4j_pipe_batches_per_epoch.argtypes = [c.c_void_p]
    lib.dl4j_pipe_destroy.argtypes = [c.c_void_p]

    lib.dl4j_imgpipe_create.restype = c.c_void_p
    lib.dl4j_imgpipe_create.argtypes = [c.c_char_p, c.c_char_p, c.c_long,
                                        c.c_long, c.c_long, c.c_long,
                                        c.c_long, c.c_long, c.c_long,
                                        c.c_long, c.c_int, c.c_int, c.c_uint,
                                        c.POINTER(c.c_float),
                                        c.POINTER(c.c_float), c.c_int,
                                        c.c_int, c.c_int]
    lib.dl4j_imgpipe_next.restype = c.c_int
    lib.dl4j_imgpipe_next.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                      c.POINTER(c.c_float)]
    lib.dl4j_imgpipe_next_u8.restype = c.c_int
    lib.dl4j_imgpipe_next_u8.argtypes = [c.c_void_p, c.POINTER(c.c_uint8),
                                         c.POINTER(c.c_float)]
    lib.dl4j_imgpipe_reset.argtypes = [c.c_void_p]
    lib.dl4j_imgpipe_batches_per_epoch.restype = c.c_long
    lib.dl4j_imgpipe_batches_per_epoch.argtypes = [c.c_void_p]
    lib.dl4j_imgpipe_destroy.argtypes = [c.c_void_p]

    lib.dl4j_csv_parse.restype = c.c_void_p
    lib.dl4j_csv_parse.argtypes = [c.c_char_p, c.c_char, c.c_int, c.c_int]
    lib.dl4j_csv_rows.restype = c.c_long
    lib.dl4j_csv_rows.argtypes = [c.c_void_p]
    lib.dl4j_csv_bad_fields.restype = c.c_long
    lib.dl4j_csv_bad_fields.argtypes = [c.c_void_p]
    lib.dl4j_csv_cols.restype = c.c_long
    lib.dl4j_csv_cols.argtypes = [c.c_void_p]
    lib.dl4j_csv_copy.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.dl4j_csv_free.argtypes = [c.c_void_p]

    lib.dl4j_cache_trim.restype = c.c_long
    lib.dl4j_cache_trim.argtypes = [c.c_char_p, c.c_long]

    lib.dl4j_wc_create.restype = c.c_void_p
    lib.dl4j_wc_create.argtypes = [c.c_char_p, c.c_int]
    lib.dl4j_wc_bytes.restype = c.c_long
    lib.dl4j_wc_bytes.argtypes = [c.c_void_p]
    lib.dl4j_wc_dump.argtypes = [c.c_void_p, c.c_char_p]
    lib.dl4j_wc_destroy.argtypes = [c.c_void_p]

    lib.dl4j_w2v_create.restype = c.c_void_p
    lib.dl4j_w2v_create.argtypes = [c.c_char_p, c.c_char_p, c.c_long,
                                    c.POINTER(c.c_float),
                                    c.POINTER(c.c_float), c.c_int, c.c_int,
                                    c.c_long, c.c_uint, c.c_int, c.c_int]
    lib.dl4j_w2v_next.restype = c.c_int
    lib.dl4j_w2v_next.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                  c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
    lib.dl4j_w2v_reset.argtypes = [c.c_void_p]
    lib.dl4j_w2v_words.restype = c.c_long
    lib.dl4j_w2v_words.argtypes = [c.c_void_p]
    lib.dl4j_w2v_pairs.restype = c.c_long
    lib.dl4j_w2v_pairs.argtypes = [c.c_void_p]
    lib.dl4j_w2v_destroy.argtypes = [c.c_void_p]

    if hasattr(lib, "dl4j_image_decode"):     # codec build present
        lib.dl4j_image_probe.restype = c.c_int
        lib.dl4j_image_probe.argtypes = [c.c_char_p, c.POINTER(c.c_long),
                                         c.POINTER(c.c_long)]
        lib.dl4j_image_decode.restype = c.c_int
        lib.dl4j_image_decode.argtypes = [c.c_char_p,
                                          c.POINTER(c.c_uint8), c.c_long,
                                          c.c_long, c.c_long]
        lib.dl4j_image_stage.restype = c.c_int
        lib.dl4j_image_stage.argtypes = [c.c_char_p, c.c_long, c.c_char_p,
                                         c.c_long, c.c_long, c.c_long,
                                         c.c_int]
    return lib


def native_csv_parse(path, delimiter: str = ",", skip_header: bool = False,
                     n_threads: int = 4):
    """Parse a numeric CSV into a float32 [rows, cols] array using the
    multi-threaded native parser; None if the native lib is unavailable or
    the file can't be parsed (caller falls back to Python)."""
    import numpy as np

    lib = load_native_lib()
    if lib is None:
        return None
    h = lib.dl4j_csv_parse(str(path).encode(), delimiter.encode(),
                           int(skip_header), n_threads)
    if not h:
        return None
    try:
        if lib.dl4j_csv_bad_fields(h):
            # non-numeric content: refuse rather than return silent zeros —
            # the Python fallback will raise (or parse strings) consistently
            return None
        rows, cols = lib.dl4j_csv_rows(h), lib.dl4j_csv_cols(h)
        out = np.empty((rows, cols), np.float32)
        lib.dl4j_csv_copy(h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out
    finally:
        lib.dl4j_csv_free(h)


def trim_compile_cache(cache_dir: Optional[str] = None,
                       cap_bytes: int = 2 << 30) -> int:
    """LRU-trim a compile-cache directory down to ``cap_bytes``: by default
    the port's build directory (the CUDA kernels' and this library's
    builds; ``DL4J_TORCH_COMPILE_CACHE`` moves it). A library a process has
    loaded stays mapped after its file goes. Returns bytes evicted (0 if
    under cap), -1 on error or without the native library."""
    if cache_dir is None:
        from deeplearning4j_tpu_torch.ops.cuda import build

        cache_dir = str(build.BUILD_DIR)
    lib = load_native_lib()
    if lib is None or not os.path.isdir(cache_dir):
        return -1
    return int(lib.dl4j_cache_trim(str(cache_dir).encode(), int(cap_bytes)))


def load_native_lib() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None if unavailable.
    One attempt per process — success and failure are both cached.

    Load order: a build of this source already in the build directory (the
    codec variant first), else a fresh build, else the committed portable
    artifact. A failed load of one candidate falls through to the next."""
    global _lib, _loaded, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        cands = []
        if _SRC.exists():
            built = [p for p in built_library_paths() if p.exists()]
            cands += built or [p for p in [_build()] if p is not None]
        cands.append(_SO)
        for cand in cands:
            if not cand.exists():
                continue
            try:
                _lib = _declare(ctypes.CDLL(str(cand)))
                _loaded = cand
                return _lib
            except (OSError, AttributeError):
                # OSError: unsatisfied dependency on this host;
                # AttributeError: a binary missing newer symbols
                _lib = None
        return _lib


def native_available() -> bool:
    return load_native_lib() is not None


def native_library_path() -> Optional[Path]:
    """The library this process loaded, or None."""
    load_native_lib()
    return _loaded


def native_built_from_source() -> bool:
    """True when the loaded library is a build of ``native/dl4jtpu_native
    .cpp`` as it stands, not the committed portable artifact."""
    path = native_library_path()
    return path is not None and path in built_library_paths()
