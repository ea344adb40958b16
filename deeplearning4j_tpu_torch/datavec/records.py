"""RecordReader implementations.

Counterpart of ``deeplearning4j_tpu/datavec/records.py``, copied (host
Python and numpy): the same files give the same records.
``CSVRecordReader.numeric_array``'s fast path is the port's build of the
native parser (``deeplearning4j_tpu_torch/native/lib.py``).

Reference analog: org.datavec.api.records.reader.RecordReader and
impls (CSVRecordReader, LineRecordReader, CollectionRecordReader,
CSVSequenceRecordReader) plus org.datavec.image.recordreader.ImageRecordReader.

A record is a list of Python values (the Writable-list analog); a sequence
record is a list of records. Readers are restartable iterators over
host-side data — ETL stays on host, the device sees finished batches only.
"""

from __future__ import annotations

import csv
import io
import os
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np


class RecordReader:
    """Iterator contract (hasNext/next/reset of the reference)."""

    def __iter__(self) -> Iterator[list]:
        self.reset()
        return self

    def __next__(self) -> list:
        if not self.has_next():
            raise StopIteration
        return self.next_record()

    # --- to implement ---
    def reset(self):
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_record(self) -> list:
        raise NotImplementedError


class CollectionRecordReader(RecordReader):
    """In-memory records (org.datavec...impl.collection.CollectionRecordReader)."""

    def __init__(self, records: Sequence[list]):
        self._records = list(records)
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._records)

    def next_record(self):
        r = self._records[self._pos]
        self._pos += 1
        return list(r)


class LineRecordReader(RecordReader):
    """One record per text line (org.datavec...impl.LineRecordReader)."""

    def __init__(self, path: str | Path):
        self._path = Path(path)
        self._lines: Optional[List[str]] = None
        self._pos = 0

    def reset(self):
        self._lines = self._path.read_text().splitlines()
        self._pos = 0

    def has_next(self):
        if self._lines is None:
            self.reset()
        return self._pos < len(self._lines)

    def next_record(self):
        line = self._lines[self._pos]
        self._pos += 1
        return [line]


class CSVRecordReader(RecordReader):
    """CSV rows as records (org.datavec...impl.csv.CSVRecordReader).

    ``skip_lines`` mirrors the reference's skipNumLines (headers);
    values parse to int/float where possible, else stay strings.
    """

    def __init__(self, path: str | Path = None, skip_lines: int = 0,
                 delimiter: str = ",", text: Optional[str] = None):
        self._path = Path(path) if path is not None else None
        self._text = text
        self._skip = skip_lines
        self._delim = delimiter
        self._rows: Optional[List[list]] = None
        self._pos = 0

    @staticmethod
    def _parse(v: str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                continue
        return v

    def reset(self):
        raw = self._text if self._text is not None else self._path.read_text()
        rows = list(csv.reader(io.StringIO(raw), delimiter=self._delim))
        self._rows = [[self._parse(v) for v in r] for r in rows[self._skip:] if r]
        self._pos = 0

    def numeric_array(self):
        """Whole file as a float32 [rows, cols] array.

        Fast path: the multi-threaded native CSV parser (native/
        dl4jtpu_native.cpp dl4j_csv_parse — the reference keeps its ETL hot
        path native the same way); falls back to the Python rows."""
        if self._path is not None and self._skip in (0, 1):
            from deeplearning4j_tpu_torch.native import native_csv_parse

            arr = native_csv_parse(self._path, delimiter=self._delim,
                                   skip_header=self._skip == 1)
            if arr is not None:
                return arr
        if self._rows is None:
            self.reset()
        return np.asarray(self._rows, dtype=np.float32)

    def has_next(self):
        if self._rows is None:
            self.reset()
        return self._pos < len(self._rows)

    def next_record(self):
        r = self._rows[self._pos]
        self._pos += 1
        return list(r)


class CSVSequenceRecordReader(RecordReader):
    """One CSV file per sequence (org.datavec...impl.csv.CSVSequenceRecordReader).

    Iterates over files in a directory (sorted); each record is a list of
    per-timestep records.
    """

    def __init__(self, directory: str | Path, skip_lines: int = 0,
                 delimiter: str = ",", glob: str = "*.csv"):
        self._dir = Path(directory)
        self._skip = skip_lines
        self._delim = delimiter
        self._glob = glob
        self._files: Optional[List[Path]] = None
        self._pos = 0

    def reset(self):
        self._files = sorted(self._dir.glob(self._glob))
        self._pos = 0

    def has_next(self):
        if self._files is None:
            self.reset()
        return self._pos < len(self._files)

    def next_record(self):
        f = self._files[self._pos]
        self._pos += 1
        inner = CSVRecordReader(f, skip_lines=self._skip, delimiter=self._delim)
        return list(inner)


class ImageRecordReader(RecordReader):
    """Images from class-subdirectory trees
    (org.datavec.image.recordreader.ImageRecordReader with
    ParentPathLabelGenerator semantics).

    Files are ``.npy`` arrays ([H, W, C] or [H, W]) — the no-egress sandbox
    has no image codec library, so the decode stage is numpy-native; the
    label is appended as the final record element (class index from the
    sorted parent-directory names), exactly like the reference appends the
    label writable.
    """

    def __init__(self, root: str | Path, height: Optional[int] = None,
                 width: Optional[int] = None, channels: int = 3):
        if (height is None) != (width is None):
            raise ValueError("give both height and width, or neither")
        self._root = Path(root)
        self._h, self._w, self._c = height, width, channels
        self._files: Optional[List[Path]] = None
        self._labels: List[str] = []
        self._pos = 0

    @property
    def labels(self) -> List[str]:
        if self._files is None:
            self.reset()
        return self._labels

    def reset(self):
        self._labels = sorted(p.name for p in self._root.iterdir() if p.is_dir())
        self._files = sorted(self._root.glob("*/*.npy"))
        self._pos = 0

    def has_next(self):
        if self._files is None:
            self.reset()
        return self._pos < len(self._files)

    def _resize(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1 and self._c > 1:
            img = np.repeat(img, self._c, axis=-1)
        if self._h and img.shape[:2] != (self._h, self._w):
            # nearest-neighbor resize, dependency-free
            ys = (np.arange(self._h) * img.shape[0] / self._h).astype(int)
            xs = (np.arange(self._w) * img.shape[1] / self._w).astype(int)
            img = img[ys][:, xs]
        return img.astype(np.float32)

    def next_record(self):
        f = self._files[self._pos]
        self._pos += 1
        img = self._resize(np.load(f))
        label = self._labels.index(f.parent.name)
        return [img, label]
