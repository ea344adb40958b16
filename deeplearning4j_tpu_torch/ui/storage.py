"""Stats storage backends.

Counterpart of ``deeplearning4j_tpu/ui/storage.py``, copied: the JSONL
format is shared, so a file either package's listener wrote reads the same
in the other.

Reference analog: org.deeplearning4j.ui.storage.{InMemoryStatsStorage,
FileStatsStorage} implementing the StatsStorage API the UI reads. Records
are flat dicts; FileStatsStorage appends JSONL (replacing mapdb).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, List, Optional


# bookkeeping fields that are not chartable scalar series
NON_SCALAR_KEYS = ("iteration", "epoch", "timestamp", "epoch_end",
                   "histograms")


class StatsStorage:
    def put(self, record: Dict) -> None:
        raise NotImplementedError

    def records(self, session_id: Optional[str] = None) -> List[Dict]:
        raise NotImplementedError

    def session_ids(self) -> List[str]:
        return sorted({r.get("session", "default") for r in self.records()})

    def scalars(self, key: str, session_id: Optional[str] = None):
        """(iteration, value) series for one scalar key."""
        out = [(r["iteration"], r[key]) for r in self.records(session_id)
               if key in r and r[key] is not None]
        return sorted(out)


class InMemoryStatsStorage(StatsStorage):
    def __init__(self):
        self._records: List[Dict] = []
        self._lock = threading.Lock()

    def put(self, record: Dict) -> None:
        with self._lock:
            self._records.append(dict(record))

    def records(self, session_id=None) -> List[Dict]:
        with self._lock:
            rs = list(self._records)
        if session_id is not None:
            rs = [r for r in rs if r.get("session", "default") == session_id]
        return rs


class FileStatsStorage(StatsStorage):
    """Append-only JSONL file store.

    ``records`` keeps an in-process parse cache keyed by file offset: each
    call reads and parses only the bytes appended since the previous call,
    so the UI's 2-second /data poll stays O(new records) over a long
    training run instead of re-parsing the whole history every poll. An
    externally truncated/rewritten file (offset shrank) invalidates the
    cache and triggers a full re-read."""

    def __init__(self, path: str | Path):
        self._path = Path(path)
        self._lock = threading.Lock()
        self._path.parent.mkdir(parents=True, exist_ok=True)
        if not self._path.exists():
            self._path.touch()
        self._cache: List[Dict] = []
        self._cache_offset = 0
        self._tail = b""          # trailing partial line (no newline yet)

    def put(self, record: Dict) -> None:
        line = json.dumps(record)
        with self._lock:
            with open(self._path, "a") as f:
                f.write(line + "\n")

    def _read_from(self, offset: int, size: int):
        """Parse records in [offset, size); returns (records, new_tail).
        Raises on a complete-but-invalid JSON line."""
        with open(self._path, "rb") as f:
            f.seek(offset)
            chunk = (self._tail if offset == self._cache_offset else b"") \
                + f.read(size - offset)
        lines = chunk.split(b"\n")
        tail = lines.pop()                         # b"" when chunk ends in \n
        return [json.loads(l) for l in lines if l.strip()], tail

    def records(self, session_id=None) -> List[Dict]:
        with self._lock:
            size = self._path.stat().st_size
            if size < self._cache_offset:          # truncated/rotated
                self._cache, self._cache_offset, self._tail = [], 0, b""
            if size > self._cache_offset:
                try:
                    parsed, tail = self._read_from(self._cache_offset, size)
                    self._cache.extend(parsed)
                except ValueError:
                    # offset landed mid-record: the file was externally
                    # REWRITTEN to an equal-or-larger size. Recover with one
                    # full re-read; a genuinely corrupt file still raises
                    # here (no silent record drops).
                    self._cache, self._tail = [], b""
                    parsed, tail = self._read_from(0, size)
                    self._cache = parsed
                self._cache_offset = size
                self._tail = tail
            rs = list(self._cache)
        if session_id is not None:
            rs = [r for r in rs if r.get("session", "default") == session_id]
        return rs

    def export_csv(self, directory: str | Path) -> List[Path]:
        """One CSV per scalar key (TensorBoard-style scalars layout)."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        keys = set()
        for r in self.records():
            keys.update(k for k, v in r.items()
                        if isinstance(v, (int, float))
                        and k not in NON_SCALAR_KEYS)
        written = []
        for k in sorted(keys):
            p = directory / f"{k}.csv"
            with open(p, "w") as f:
                f.write("iteration,value\n")
                for it, v in self.scalars(k):
                    f.write(f"{it},{v}\n")
            written.append(p)
        return written
