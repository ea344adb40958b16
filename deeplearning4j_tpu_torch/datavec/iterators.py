"""RecordReader -> DataSet bridge.

Counterpart of ``deeplearning4j_tpu/datavec/iterators.py``, copied: the same
records give the same host numpy ``DataSet`` bit for bit; a network's
``fit_batch`` moves each batch to its device.

Reference analog: org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator
(and SequenceRecordReaderDataSetIterator) — converts Writable records into
(features, one-hot labels) minibatches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datavec.records import RecordReader


class RecordReaderDataSetIterator:
    """Batches records into DataSets.

    ``label_index``: which record element is the label (appended last by
    ImageRecordReader; a column index for CSV); ``num_classes`` one-hot
    encodes integer labels; ``regression`` keeps labels as floats.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        if not regression and num_classes is None:
            # per-batch inference would give inconsistent one-hot widths
            raise ValueError("classification requires num_classes (the "
                             "reference's numPossibleLabels)")

    def reset(self):
        self.reader.reset()

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        feats, labels = [], []
        while len(feats) < self.batch_size and self.reader.has_next():
            r = self.reader.next_record()
            li = self.label_index if self.label_index >= 0 else len(r) + self.label_index
            label = r[li]
            fvals = [v for i, v in enumerate(r) if i != li]
            if len(fvals) == 1 and isinstance(fvals[0], np.ndarray):
                feats.append(fvals[0])
            else:
                feats.append(np.asarray(fvals, np.float32))
            labels.append(label)
        if not feats:
            raise StopIteration
        x = np.stack(feats)
        if self.regression:
            y = np.asarray(labels, np.float32).reshape(len(labels), -1)
        else:
            y = np.eye(self.num_classes,
                       dtype=np.float32)[np.asarray(labels, np.int64)]
        return DataSet(x, y)


class SequenceRecordReaderDataSetIterator:
    """Sequence records -> padded [B, T, F] DataSets with masks.

    Reference analog: org.deeplearning4j.datasets.datavec
    .SequenceRecordReaderDataSetIterator (single-reader mode: each sequence
    step carries features + the label at ``label_index``). Variable-length
    sequences are right-padded to the longest in the batch, with
    features/labels masks marking valid steps — the reference's
    ALIGN_END/ALIGN_START collapses to the standard right-pad + mask here
    (align="end" left-pads instead).
    """

    def __init__(self, reader, batch_size: int, label_index: int = -1,
                 num_classes: Optional[int] = None, regression: bool = False,
                 align: str = "start"):
        if not regression and num_classes is None:
            raise ValueError("classification requires num_classes")
        if align not in ("start", "end"):
            raise ValueError("align must be 'start' or 'end'")
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.align = align

    def reset(self):
        self.reader.reset()

    def __iter__(self):
        self.reset()
        return self

    def _split(self, seq):
        feats, labels = [], []
        for r in seq:
            li = (self.label_index if self.label_index >= 0
                  else len(r) + self.label_index)
            labels.append(r[li])
            feats.append([float(v) for i, v in enumerate(r) if i != li])
        return np.asarray(feats, np.float32), labels

    def __next__(self) -> DataSet:
        seqs = []
        while len(seqs) < self.batch_size and self.reader.has_next():
            seqs.append(self.reader.next_record())
        if not seqs:
            raise StopIteration
        parts = [self._split(s) for s in seqs]
        tmax = max(f.shape[0] for f, _ in parts)
        nf = parts[0][0].shape[1]
        b = len(parts)
        x = np.zeros((b, tmax, nf), np.float32)
        mask = np.zeros((b, tmax), np.float32)
        if self.regression:
            y = np.zeros((b, tmax, 1), np.float32)
        else:
            y = np.zeros((b, tmax, self.num_classes), np.float32)
        for j, (f, labels) in enumerate(parts):
            t = f.shape[0]
            sl = slice(tmax - t, tmax) if self.align == "end" else slice(0, t)
            x[j, sl] = f
            mask[j, sl] = 1.0
            if self.regression:
                y[j, sl, 0] = np.asarray(labels, np.float32)
            else:
                y[j, sl] = np.eye(self.num_classes, dtype=np.float32)[
                    np.asarray(labels, np.int64)]
        return DataSet(x, y, features_mask=mask, labels_mask=mask.copy())
