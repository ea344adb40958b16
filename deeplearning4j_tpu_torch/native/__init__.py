"""Native runtime bindings (ctypes over native/dl4jtpu_native.cpp).

Counterpart of ``deeplearning4j_tpu/native/``. Reference analog (libnd4j's
workspace allocator and the prefetch queues of AsyncDataSetIterator /
ParallelWrapper): the host-side runtime around the device compute path.
The library is built with g++ at first use into the port's build
directory (``lib.py``); every entry point has a pure-Python fallback for a
host with no toolchain.
"""

from deeplearning4j_tpu_torch.native.lib import (
    load_native_lib, native_available, native_csv_parse, trim_compile_cache,
)
from deeplearning4j_tpu_torch.native.workspace import Workspace
from deeplearning4j_tpu_torch.native.pipeline import (
    NativeDataSetIterator, NativeImageDataSetIterator, decode_image_file,
    image_files_iterator, probe_image, stage_image_files,
    write_binary_dataset, write_image_dataset,
)

__all__ = ["load_native_lib", "native_available", "Workspace",
           "NativeDataSetIterator", "NativeImageDataSetIterator",
           "write_binary_dataset", "write_image_dataset",
           "decode_image_file", "image_files_iterator", "probe_image",
           "stage_image_files", "native_csv_parse", "trim_compile_cache"]
