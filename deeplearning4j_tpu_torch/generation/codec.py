"""Character codec for char-RNN style generation (a copy of the JAX
package's framework-free ``generation/codec.py``).

Reference analog: dl4j-examples' CharacterIterator — the fixed character
alphabet the GravesLSTM char-modelling example indexes into. The engine is
token-id native; a codec is only the string boundary the HTTP route and
examples use.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence


class CharCodec:
    """Bijective char <-> id mapping over a fixed alphabet. Unknown chars
    encode to ``unk_id`` (default: drop them, the CharacterIterator
    behaviour)."""

    def __init__(self, alphabet: Sequence[str], unk_id: int = -1):
        self.alphabet = list(alphabet)
        self.unk_id = unk_id
        self._to_id = {c: i for i, c in enumerate(self.alphabet)}
        if len(self._to_id) != len(self.alphabet):
            raise ValueError("alphabet has duplicate characters")

    @classmethod
    def ascii_printable(cls) -> "CharCodec":
        """The 95 printable ASCII chars + newline — a serviceable default
        alphabet for char-RNN demos."""
        return cls([chr(c) for c in range(32, 127)] + ["\n"])

    @property
    def vocab_size(self) -> int:
        return len(self.alphabet)

    def encode(self, text: str) -> List[int]:
        if self.unk_id < 0:
            return [self._to_id[c] for c in text if c in self._to_id]
        return [self._to_id.get(c, self.unk_id) for c in text]

    def decode(self, ids: Iterable[int]) -> str:
        n = len(self.alphabet)
        return "".join(self.alphabet[i] for i in ids if 0 <= i < n)
