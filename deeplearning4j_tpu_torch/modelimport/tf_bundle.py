"""TensorFlow checkpoint bundle reader (variables.index / variables.data-*).

Counterpart of ``deeplearning4j_tpu/modelimport/tf_bundle.py`` (numpy and
the standard library only, as there). SavedModel directories keep weights
in a tensor-bundle checkpoint instead of Const nodes, so importing one
requires reading the bundle. Dependency-free like the rest of the importers: the
.index file is a LevelDB-format SSTable (prefix-compressed keys, restart
array, block trailer, 48-byte footer with magic 0xdb4775248b80fb57) whose
values are BundleEntryProto records {dtype, shape, shard, offset, size};
tensor bytes live in the .data-NNNNN-of-MMMMM shards at those offsets,
row-major little-endian.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.modelimport.tensorflow import (
    _read_varint as _varint, parse_message)

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy (the types a weight checkpoint can hold)
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 14: None,  # 14 = bfloat16
    17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64,
}


def _block_handle(buf: bytes, pos: int) -> Tuple[int, int, int]:
    off, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return off, size, pos


def _read_block(buf: bytes, off: int, size: int) -> Dict[bytes, bytes]:
    """All key->value entries of one table block (full scan — import reads
    every tensor anyway, so no binary search through restarts needed)."""
    kind = buf[off + size]  # 1-byte trailer: 0 = raw, 1 = snappy
    if kind != 0:
        raise NotImplementedError(
            "compressed checkpoint table blocks are not supported "
            f"(compression type {kind}); write checkpoints without table "
            "compression (the TF default)")
    block = buf[off:off + size]
    (num_restarts,) = struct.unpack("<I", block[-4:])
    limit = len(block) - 4 * (num_restarts + 1)
    entries: Dict[bytes, bytes] = {}
    key = b""
    pos = 0
    while pos < limit:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        entries[key] = block[pos:pos + vlen]
        pos += vlen
    return entries


def read_index(path) -> Dict[bytes, bytes]:
    """Every key->value entry of a tensor-bundle .index table."""
    buf = Path(path).read_bytes()
    (magic,) = struct.unpack("<Q", buf[-8:])
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: not a TF checkpoint index (bad magic)")
    footer = buf[-48:]
    _, _, pos = _block_handle(footer, 0)            # metaindex (unused)
    idx_off, idx_size, _ = _block_handle(footer, pos)
    out: Dict[bytes, bytes] = {}
    for handle in _read_block(buf, idx_off, idx_size).values():
        doff, dsize, _ = _block_handle(handle, 0)
        out.update(_read_block(buf, doff, dsize))
    return out


def _parse_shape(buf: bytes) -> list:
    dims = []
    for d in parse_message(buf).get(2, []):
        dims.append(parse_message(d).get(1, [0])[0])
    return dims


def read_variables(prefix, raw: Optional[Dict[str, bytes]] = None
                   ) -> Dict[str, np.ndarray]:
    """{tensor_name: ndarray} from a bundle checkpoint ``prefix`` (e.g.
    <saved_model_dir>/variables/variables). Entries with non-numeric
    dtypes (e.g. the DT_STRING _CHECKPOINTABLE_OBJECT_GRAPH proto of TF2
    checkpoints) are skipped — their raw bytes are collected into ``raw``
    when a dict is passed."""
    prefix = str(prefix)
    entries = read_index(prefix + ".index")
    header = parse_message(entries.pop(b"", b""))
    num_shards = header.get(1, [1])[0] or 1
    shards: Dict[int, bytes] = {}

    def shard(i: int) -> bytes:
        if i not in shards:
            shards[i] = Path(
                f"{prefix}.data-{i:05d}-of-{num_shards:05d}").read_bytes()
        return shards[i]

    out: Dict[str, np.ndarray] = {}
    for key, val in entries.items():
        entry = parse_message(val)
        if 7 in entry:      # slice-saved tensor: partial entries follow
            raise NotImplementedError(
                f"sliced checkpoint tensor {key!r} is not supported")
        dt = entry.get(1, [1])[0]
        shape = _parse_shape(entry.get(2, [b""])[0])
        shard_id = entry.get(3, [0])[0]
        offset = entry.get(4, [0])[0]
        size = entry.get(5, [0])[0]
        data = shard(shard_id)[offset:offset + size]
        if dt == 14:        # bfloat16: u16 -> f32 via bit shift
            u16 = np.frombuffer(data, np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            np_dt = _DTYPES.get(dt)
            if np_dt is None:
                if raw is None:   # caller gets no diagnostic channel: raise
                    raise NotImplementedError(
                        f"checkpoint tensor {key!r} has unsupported "
                        f"dtype {dt}")
                raw[key.decode()] = data
                continue
            arr = np.frombuffer(data, np_dt)
        out[key.decode()] = arr.reshape(shape).copy()
    return out


def string_tensor_elements(data: bytes, n: int = 1) -> list:
    """Decode a bundle DT_STRING tensor payload: n varint64 lengths, a
    4-byte crc32c of those lengths, then the concatenated bytes."""
    lens = []
    pos = 0
    for _ in range(n):
        v, pos = _varint(data, pos)
        lens.append(v)
    pos += 4                       # crc32c(lengths)
    out = []
    for ln in lens:
        out.append(data[pos:pos + ln])
        pos += ln
    return out
