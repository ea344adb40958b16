"""Word-vector interchange formats.

Counterpart of ``deeplearning4j_tpu/nlp/serializer.py``, copied; files
written by either package read in the other.

Reference analog: org.deeplearning4j.models.embeddings.loader.
WordVectorSerializer — the reference reads/writes the ORIGINAL word2vec
formats (Mikolov's text and binary layouts), which is what makes its
embeddings interoperable with gensim/fastText/the C tool. Same here:

- text:   header line "V D", then one "word f1 f2 ... fD" line per word
- binary: header line "V D\\n", then per word: "word " + D float32
          (little-endian) + "\\n"

Both round-trip through ``Word2Vec`` (the output C/Theta side is not part
of the interchange format — only the input embeddings travel, exactly like
the reference).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np


def write_word_vectors(words: List[str], W, path: str,
                       binary: bool = False) -> None:
    """WordVectorSerializer.writeWordVectors: the original word2vec
    formats. ``W`` is [V, D]; words[i] labels row i."""
    W = np.asarray(W, np.float32)
    if len(words) != W.shape[0]:
        raise ValueError(f"{len(words)} words vs {W.shape[0]} vector rows")
    if binary:
        with open(path, "wb") as f:
            f.write(f"{W.shape[0]} {W.shape[1]}\n".encode())
            for w, row in zip(words, W):
                f.write(w.encode("utf-8") + b" ")
                f.write(row.astype("<f4").tobytes())
                f.write(b"\n")
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{W.shape[0]} {W.shape[1]}\n")
            for w, row in zip(words, W):
                f.write(w + " " + " ".join(f"{v:.6g}" for v in row) + "\n")


def read_word_vectors(path: str,
                      binary: bool = False) -> Tuple[List[str], np.ndarray]:
    """WordVectorSerializer.loadTxtVectors / readWord2VecModel: returns
    (words, W [V, D] float32). The text reader tolerates a missing header
    (some exporters omit it) by inferring V/D from the first data line."""
    if binary:
        with open(path, "rb") as f:
            header = b""
            while not header.endswith(b"\n"):
                c = f.read(1)
                if not c:
                    raise ValueError("truncated binary word2vec file")
                header += c
            V, D = (int(x) for x in header.split())
            words, rows = [], []
            for _ in range(V):
                w = b""
                while True:
                    c = f.read(1)
                    if not c:
                        raise ValueError("truncated binary word2vec file")
                    if c == b" ":
                        break
                    w += c
                buf = f.read(4 * D)
                if len(buf) != 4 * D:
                    raise ValueError("truncated binary word2vec file")
                rows.append(np.frombuffer(buf, "<f4"))
                nl = f.read(1)          # trailing separator (C tool: '\n')
                if nl not in (b"\n", b"", b" "):
                    # some writers omit it; step back for the next word
                    f.seek(-1, 1)
                words.append(w.decode("utf-8", errors="replace").lstrip("\n"))
            return words, np.vstack(rows).astype(np.float32)
    words, rows = [], []
    V = D = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        first = ""
        consumed = 0
        while not first.strip():        # tolerate leading blank lines
            first = f.readline()
            consumed += 1
            if not first:
                raise ValueError(f"{path}: empty word-vector file")
        parts = first.split()
        if len(parts) == 2 and all(p.isdigit() for p in parts):
            V, D = int(parts[0]), int(parts[1])   # "V D" header
        else:                           # headerless: first line is data
            # infer D from the trailing float-parseable fields — a first
            # WORD containing spaces ("new york 0.1 ...") must not inflate
            # D and mis-split every later row (ADVICE r5). At least one
            # leading field is always the word, so the scan stops there;
            # an all-numeric line keeps the old single-token-word reading.
            D = 0
            for p in reversed(parts[1:]):
                try:
                    float(p)
                except ValueError:
                    break
                D += 1
            if D == 0:
                raise ValueError(
                    f"{path}:1: headerless first line has no trailing "
                    f"float fields to infer the vector dimension from")
            words.append(" ".join(parts[:-D]))
            rows.append(np.asarray([float(v) for v in parts[-D:]],
                                   np.float32))
        for lineno, line in enumerate(f, consumed + 1):
            parts = line.split()        # any whitespace separates fields
            if not parts:
                continue                # blank line
            if len(parts) < D + 1:
                raise ValueError(
                    f"{path}:{lineno}: expected a word + {D} floats, got "
                    f"{len(parts)} fields")
            # words may contain spaces in some exports: floats are the
            # LAST D fields, the word is everything before them
            try:
                row = np.asarray([float(v) for v in parts[-D:]], np.float32)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno}: last {D} fields must be floats "
                    f"({e})") from None
            words.append(" ".join(parts[:-D]))
            rows.append(row)
    if V is not None and len(words) != V:
        # also catches the ambiguous case of a headerless file whose
        # first line happened to look like a "V D" header
        raise ValueError(
            f"{path}: header declares {V} vectors but {len(words)} data "
            f"lines were read")
    if not rows:
        raise ValueError(f"{path}: no word vectors found")
    return words, np.vstack(rows)


def save_word2vec(model, path: str, binary: bool = False) -> None:
    """Write a fitted Word2Vec's input embeddings in the interchange
    format (reference: WordVectorSerializer.writeWord2VecModel)."""
    write_word_vectors(model.vocab.words, model.W, path, binary=binary)


def load_word2vec(path: str, binary: bool = False, device=None):
    """Read a word2vec text/binary file into a query-ready Word2Vec
    (similarity / words_nearest work; further training starts fresh —
    the interchange formats carry no output-side vectors, as in the
    reference). ``device`` is the model's (the card when None)."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    words, W = read_word_vectors(path, binary=binary)
    m = Word2Vec(vector_size=W.shape[1], device=device)
    m.W = W
    m.C = np.zeros_like(W)
    m.vocab.words = list(words)
    m.vocab.index = {w: i for i, w in enumerate(words)}
    return m
