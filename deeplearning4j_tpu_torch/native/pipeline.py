"""Native prefetching DataSet iterator.

Counterpart of ``deeplearning4j_tpu/native/pipeline.py``. The host half
(the threaded C++ workers, the numpy pipelines for a host without the
library, the writers and the image-file front) is copied and yields the
port's ``DataSet``. The device half is PyTorch: ``normalize`` is one
affine op on the batch's device, and ``device_prefetch`` copies the next
batch from pinned host memory on a side stream while the current one
trains; the consumer's stream waits on that copy's event.

Reference analog: AsyncDataSetIterator + ParallelWrapper's prefetch queues
(org.deeplearning4j.datasets.iterator.AsyncDataSetIterator) — producer
threads keeping batches ahead of the training step, implemented in C++
(native/dl4jtpu_native.cpp) instead of Java threads. Falls back to a numpy
implementation when no toolchain is available.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.device import DeviceLike, resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.native.lib import load_native_lib

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.float32): torch.float32}


def write_binary_dataset(directory, features: np.ndarray, labels: np.ndarray
                         ) -> Tuple[str, str]:
    """Flat-float32 export consumed by the native pipeline (the interchange
    format standing in for the reference's DataSet binary serialization)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    f = directory / "features.bin"
    l = directory / "labels.bin"
    np.ascontiguousarray(features, np.float32).tofile(f)
    np.ascontiguousarray(labels, np.float32).tofile(l)
    return str(f), str(l)


class NativeDataSetIterator:
    """Iterates (features, labels) batches assembled by native worker threads.

    features file: [n, feat_dim] float32, labels file: [n, label_dim].
    Drop-last semantics; reshuffles per epoch when shuffle=True.
    """

    def __init__(self, feat_path: str, label_path: str, n: int,
                 feat_shape, label_shape, batch_size: int,
                 shuffle: bool = True, seed: int = 0, n_threads: int = 2,
                 queue_cap: int = 4):
        self.feat_shape = tuple(feat_shape)
        self.label_shape = tuple(label_shape)
        self.feat_dim = int(np.prod(self.feat_shape))
        self.label_dim = int(np.prod(self.label_shape))
        self.batch_size = batch_size
        self.n = n
        self._lib = load_native_lib()
        self._handle = None
        self._fallback: Optional[_PyPipeline] = None
        if self._lib is not None:
            self._handle = self._lib.dl4j_pipe_create(
                feat_path.encode(), label_path.encode(), n, self.feat_dim,
                self.label_dim, batch_size, int(shuffle), seed, n_threads,
                queue_cap)
        if self._handle is None:
            self._fallback = _PyPipeline(feat_path, label_path, n,
                                         self.feat_dim, self.label_dim,
                                         batch_size, shuffle, seed)
        self._feat_buf = np.empty((batch_size, self.feat_dim), np.float32)
        self._label_buf = np.empty((batch_size, self.label_dim), np.float32)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def batches_per_epoch(self) -> int:
        if self._handle is not None:
            return int(self._lib.dl4j_pipe_batches_per_epoch(self._handle))
        return self._fallback.n_batches

    def __iter__(self):
        return self

    def __next__(self) -> DataSet:
        if self._handle is not None:
            rc = self._lib.dl4j_pipe_next(
                self._handle,
                self._feat_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._label_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if rc == 1:
                raise StopIteration
            if rc != 0:
                raise RuntimeError("native pipeline error")
            f = self._feat_buf.reshape((self.batch_size,) + self.feat_shape).copy()
            y = self._label_buf.reshape((self.batch_size,) + self.label_shape).copy()
            return DataSet(f, y)
        return self._fallback.next(self.feat_shape, self.label_shape)

    def reset(self):
        if self._handle is not None:
            self._lib.dl4j_pipe_reset(self._handle)
        else:
            self._fallback.reset()

    def close(self):
        if self._handle is not None:
            self._lib.dl4j_pipe_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _PyPipeline:
    """Pure-python fallback with identical semantics."""

    def __init__(self, feat_path, label_path, n, feat_dim, label_dim,
                 batch, shuffle, seed):
        self.feats = np.fromfile(feat_path, np.float32).reshape(n, feat_dim)
        self.labels = np.fromfile(label_path, np.float32).reshape(n, label_dim)
        self.batch = batch
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.n_batches = n // batch
        self._reshuffle()

    def _reshuffle(self):
        self.order = np.arange(len(self.feats))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(self.order)
        self.pos = 0

    def next(self, feat_shape, label_shape) -> DataSet:
        if self.pos >= self.n_batches:
            raise StopIteration
        idx = self.order[self.pos * self.batch:(self.pos + 1) * self.batch]
        self.pos += 1
        return DataSet(
            self.feats[idx].reshape((self.batch,) + tuple(feat_shape)).copy(),
            self.labels[idx].reshape((self.batch,) + tuple(label_shape)).copy())

    def reset(self):
        self.epoch += 1
        self._reshuffle()


def write_image_dataset(directory, images: np.ndarray, labels: np.ndarray
                        ) -> Tuple[str, str]:
    """uint8 [n, H, W, C] image export for the native image pipeline (4x
    smaller at rest than float32; normalization happens in the C++ workers)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    f = directory / "images.u8"
    l = directory / "labels.bin"
    np.ascontiguousarray(images, np.uint8).tofile(f)
    np.ascontiguousarray(labels, np.float32).tofile(l)
    return str(f), str(l)


class NativeImageDataSetIterator:
    """ImageNet-class input path: threaded C++ decode->augment->normalize
    producing float32 NHWC batches, with optional async DEVICE prefetch
    onto ``device`` (the card unless the caller passes ``device="cpu"``).

    Reference analog: DataVec ImageRecordReader + ImagePreProcessingScaler +
    AsyncDataSetIterator stacked — random crop + horizontal flip + per-
    channel normalize run in native worker threads; ``device_prefetch``
    stages the NEXT batch onto the accelerator while the current one trains
    (the host->device overlap the reference gets from its prefetch queues).

    augment=True: random crop to (crop_h, crop_w) + random horizontal flip,
    fresh draws every epoch. augment=False: deterministic center crop (eval).
    """

    def __init__(self, img_path: str, label_path: str, n: int, image_shape,
                 label_dim: int, batch_size: int, crop=None,
                 shuffle: bool = True, augment: bool = True, seed: int = 0,
                 mean=None, std=None, n_threads: int = 4, queue_cap: int = 4,
                 device_prefetch: bool = False, output: str = "f32",
                 device: DeviceLike = None):
        """``output``: "f32" — workers normalize on the host (the DataVec
        ImagePreProcessingScaler behavior); "u8" — workers only crop/flip
        and batches stay uint8 (4x less host traffic AND host->device
        transfer), with ``normalize()`` applying (x/255 - mean)/std ON
        DEVICE as one affine op.

        With ``device_prefetch`` the batches are tensors on ``device``;
        without it they stay host numpy, as in the JAX package."""
        H, W, C = image_shape
        crop_h, crop_w = crop if crop is not None else (H, W)
        if output not in ("f32", "u8"):
            raise ValueError(f"output must be 'f32' or 'u8', got {output!r}")
        self.output = output
        self.batch_size = batch_size
        self.out_shape = (batch_size, crop_h, crop_w, C)
        self.label_dim = label_dim
        self._device_prefetch = device_prefetch
        self._device_arg = device
        self._device = (resolve_device("cuda" if device is None else device)
                        if device_prefetch else None)
        self._copy_stream = None
        self._in_flight = []   # (event, pinned host buffers) per copy
        self._staged = None
        mean = np.asarray(mean if mean is not None else [0.0] * C, np.float32)
        std = np.asarray(std if std is not None else [1.0] * C, np.float32)
        if mean.size != C or std.size != C:
            raise ValueError(f"mean/std must have {C} channel entries")
        self.mean, self.std = mean, std
        self._lib = load_native_lib()
        self._handle = None
        self._py = None
        self._exhausted = False
        if self._lib is not None:
            self._handle = self._lib.dl4j_imgpipe_create(
                img_path.encode(), label_path.encode(), n, H, W, C,
                label_dim, crop_h, crop_w, batch_size, int(shuffle),
                int(augment), seed,
                mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n_threads, queue_cap, int(output == "u8"))
        if self._handle is None:
            self._py = _PyImagePipeline(img_path, label_path, n, (H, W, C),
                                        label_dim, (crop_h, crop_w),
                                        batch_size, shuffle, augment, seed,
                                        mean, std, u8=(output == "u8"))
        self._label_buf = np.empty((batch_size, label_dim), np.float32)
        self._affine = {}   # device -> (a, b) tensors

    def normalize(self, x):
        """(x/255 - mean)/std for output="u8" batches, as
        ``u8 * 1/(255 std) - mean/std`` in f32 on the batch's device; a
        host array goes to the iterator's device first (the card unless
        the iterator was given ``device="cpu"``)."""
        if not isinstance(x, torch.Tensor):
            dev = self._device or resolve_device(
                "cuda" if self._device_arg is None else self._device_arg)
            x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        ab = self._affine.get(x.device)
        if ab is None:
            a = np.asarray(1.0 / (255.0 * self.std), np.float32)
            b = np.asarray(-self.mean / self.std, np.float32)
            ab = self._affine[x.device] = (torch.from_numpy(a).to(x.device),
                                           torch.from_numpy(b).to(x.device))
        return x.to(torch.float32) * ab[0] + ab[1]

    @property
    def native(self) -> bool:
        return self._handle is not None

    def batches_per_epoch(self) -> int:
        if self._handle is not None:
            return int(self._lib.dl4j_imgpipe_batches_per_epoch(self._handle))
        return self._py.n_batches

    def _host_array(self, shape, dtype):
        """A fresh host buffer: pinned when batches go to the card, so the
        copy there runs asynchronously (a copy from pageable memory is
        synchronous)."""
        if self._device is not None and self._device.type == "cuda":
            return torch.empty(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)],
                               pin_memory=True).numpy()
        return np.empty(shape, dtype)

    def _fetch_host(self):
        """Next (features, labels) as host numpy, or None at epoch end.
        Writes into FRESH arrays (no reuse-then-copy: the consumer owns the
        buffers, and one copy per batch is one too many at model rate)."""
        if self._handle is not None:
            if self.output == "u8":
                feat = self._host_array(self.out_shape, np.uint8)
                rc = self._lib.dl4j_imgpipe_next_u8(
                    self._handle,
                    feat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._label_buf.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_float)))
            else:
                feat = self._host_array(self.out_shape, np.float32)
                rc = self._lib.dl4j_imgpipe_next(
                    self._handle,
                    feat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    self._label_buf.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_float)))
            if rc == 1:
                return None
            if rc != 0:
                raise RuntimeError("native image pipeline failed")
            labels = self._host_array(self._label_buf.shape, np.float32)
            labels[...] = self._label_buf
            return feat, labels
        return self._py.next()

    def _stage(self, host):
        """Start the batch's copy to the device: on the card, from pinned
        memory on a side stream, with an event the consumer waits on."""
        if host is None:
            return None
        if not self._device_prefetch:
            return host
        dev = self._device
        if dev.type != "cuda":
            return tuple(torch.from_numpy(a).to(dev) for a in host)
        pinned = [torch.from_numpy(a) for a in host]
        if not all(t.is_pinned() for t in pinned):
            pinned = [t.pin_memory() for t in pinned]
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._copy_stream):
            out = tuple(t.to(dev, non_blocking=True) for t in pinned)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        # the host buffers stay alive until the copy has ended
        self._in_flight.append((done, pinned))
        return out + (done,)

    def _hand_over(self, staged):
        """(features, labels) for the consumer: its stream waits on the
        copy, and the copy's memory is marked as used there."""
        if len(staged) == 2:
            return staged
        feat, labels, done = staged
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(done)
        for t in (feat, labels):
            t.record_stream(consumer)
        self._in_flight = [(e, p) for e, p in self._in_flight
                           if not e.query()]
        return feat, labels

    def __iter__(self):
        # a finished epoch re-iterated without an explicit reset() advances
        # the epoch ONCE here; fit() calls reset() itself between epochs, in
        # which case _exhausted is already cleared and nothing double-resets
        if self._exhausted:
            self.reset()
        if self._staged is None:  # keep an already-prefetched batch
            self._staged = self._stage(self._fetch_host())
        return self

    def __next__(self) -> DataSet:
        cur = self._staged
        if cur is None:
            self._exhausted = True
            raise StopIteration
        # stage the NEXT batch before handing the current one to the trainer
        self._staged = self._stage(self._fetch_host())
        feat, labels = self._hand_over(cur)
        return DataSet(feat, labels)

    def reset(self):
        if self._handle is not None:
            self._lib.dl4j_imgpipe_reset(self._handle)
        else:
            self._py.reset()
        self._staged = None
        self._exhausted = False

    def close(self):
        if self._handle is not None:
            self._lib.dl4j_imgpipe_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _PyImagePipeline:
    """Numpy fallback with the same contract (different RNG stream)."""

    def __init__(self, img_path, label_path, n, shape, label_dim, crop,
                 batch, shuffle, augment, seed, mean, std, u8=False):
        H, W, C = shape
        self.u8 = u8
        self.images = np.fromfile(img_path, np.uint8).reshape(n, H, W, C)
        self.labels = np.fromfile(label_path, np.float32).reshape(n, label_dim)
        self.crop = crop
        self.batch = batch
        self.shuffle = shuffle
        self.augment = augment
        self.seed = seed
        self.epoch = 0
        self.mean, self.std = mean, std
        self.n_batches = n // batch
        self._start()

    def _start(self):
        self._rng = np.random.default_rng(self.seed + self.epoch)
        self._order = (self._rng.permutation(len(self.images)) if self.shuffle
                       else np.arange(len(self.images)))
        self._pos = 0

    def next(self):
        if self._pos >= self.n_batches:
            return None
        ch, cw = self.crop
        H, W = self.images.shape[1:3]
        idx = self._order[self._pos * self.batch:(self._pos + 1) * self.batch]
        feats = np.empty((self.batch, ch, cw, self.images.shape[3]),
                         np.uint8 if self.u8 else np.float32)
        for r, src in enumerate(idx):
            if self.augment:
                top = self._rng.integers(0, H - ch + 1)
                left = self._rng.integers(0, W - cw + 1)
                flip = bool(self._rng.integers(0, 2))
            else:
                top, left, flip = (H - ch) // 2, (W - cw) // 2, False
            img = self.images[src, top:top + ch, left:left + cw]
            if flip:
                img = img[:, ::-1]
            if self.u8:
                feats[r] = img
            else:
                feats[r] = (img.astype(np.float32) / 255.0
                            - self.mean) / self.std
        self._pos += 1
        return feats, self.labels[idx].copy()

    def reset(self):
        self.epoch += 1
        self._start()


# --------------------------------------------------------------- image files
# Decode front for the staging format (SURVEY.md §2.3 Datasets/fetchers:
# DataVec's ImageRecordReader reads actual image FILES). JPEG/PNG entropy
# decode + bilinear resize run in the native library (libjpeg/libpng,
# threaded, order-preserving); PIL is the fallback when the native build
# has no codecs.


def probe_image(path) -> Tuple[int, int]:
    """(height, width) of an image file without a full decode."""
    lib = load_native_lib()
    if lib is not None and hasattr(lib, "dl4j_image_probe"):
        h = ctypes.c_long()
        w = ctypes.c_long()
        if lib.dl4j_image_probe(str(path).encode(), ctypes.byref(h),
                                ctypes.byref(w)) == 0:
            return int(h.value), int(w.value)
        # non-JPEG/PNG format: PIL fallback below
    from PIL import Image

    with Image.open(path) as im:
        return im.height, im.width


def decode_image_file(path, image_shape) -> np.ndarray:
    """Decode one JPEG/PNG file to uint8 [H, W, C] (C=3 RGB / C=1 gray),
    bilinear-resized to the staging shape."""
    H, W, C = image_shape
    lib = load_native_lib()
    if lib is not None and hasattr(lib, "dl4j_image_decode"):
        out = np.empty((H, W, C), np.uint8)
        rc = lib.dl4j_image_decode(
            str(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, C)
        if rc == 0:
            return out
        # the native front covers JPEG/PNG; other formats (bmp/webp/...)
        # fall through to PIL so a codec build never supports FEWER
        # formats than a codec-less one
    return _pil_decode(path, image_shape)


def _pil_decode(path, image_shape) -> np.ndarray:
    from PIL import Image

    H, W, C = image_shape
    with Image.open(path) as im:
        im = im.convert("L" if C == 1 else "RGB")
        if (im.height, im.width) != (H, W):
            im = im.resize((W, H), Image.BILINEAR)
        a = np.asarray(im, np.uint8)
    return a[..., None] if C == 1 else a


def stage_image_files(paths, labels, directory, image_shape,
                      n_threads: int = 8) -> Tuple[str, str]:
    """Decode image files ONCE into the uint8 staging pair
    (images.u8 [n, H, W, C], labels.bin [n, label_dim]) consumed by
    NativeImageDataSetIterator — epochs then re-crop/flip/normalize from
    staged uint8 without touching the codecs again."""
    H, W, C = image_shape
    paths = [str(p) for p in paths]
    labels = np.ascontiguousarray(labels, np.float32)
    if len(paths) != len(labels):
        raise ValueError(f"{len(paths)} paths vs {len(labels)} labels")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    img_path = directory / "images.u8"
    label_path = directory / "labels.bin"
    lib = load_native_lib()
    rc = -1
    if lib is not None and hasattr(lib, "dl4j_image_stage"):
        rc = lib.dl4j_image_stage("\n".join(paths).encode(), len(paths),
                                  str(img_path).encode(), H, W, C, n_threads)
    if rc != 0:
        # no codec build, or some files the native front can't decode
        # (non-JPEG/PNG in the mix): stream per-file — decode_image_file
        # still uses the native decoder for each JPEG/PNG and PIL only for
        # the odd formats; one image in memory at a time
        with open(img_path, "wb") as f:
            for p in paths:
                f.write(decode_image_file(p, image_shape).tobytes())
    labels.tofile(label_path)
    return str(img_path), str(label_path)


def image_files_iterator(paths, labels, image_shape, label_dim,
                         batch_size, directory=None, **kwargs
                         ) -> "NativeImageDataSetIterator":
    """ImageRecordReader-style entry: image FILES -> staged uint8 ->
    threaded augment/normalize iterator. ``directory`` keeps the staging
    pair for reuse across runs (defaults to a temp dir)."""
    import shutil
    import tempfile

    own_dir = directory is None
    directory = directory or tempfile.mkdtemp(prefix="dl4j_imgstage_")
    try:
        img_path, label_path = stage_image_files(paths, labels, directory,
                                                 image_shape)
        return NativeImageDataSetIterator(img_path, label_path, len(paths),
                                          image_shape, label_dim, batch_size,
                                          **kwargs)
    finally:
        # the pipeline loads the staging pair into memory at construction;
        # a temp dir WE created must not leak a dataset-sized file per call
        if own_dir:
            shutil.rmtree(directory, ignore_errors=True)
