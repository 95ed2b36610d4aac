"""String interning for atom/residue/chain/type names.

The reference stores names as 8-byte stack ASCII strings in SoA columns
(molar/src/atom.rs:6, atom_storage.rs:31-48). On the TPU side string predicates
are compile-time (host) work, so names become int32 *codes* into a per-column
string table. Selection keywords then reduce to ``isin(codes, matched_codes)``
— one vectorized integer compare instead of N string compares — and regexes run
once over the (tiny) unique-string table instead of over N atoms.

The port's own copy of ``molar_tpu.core.interner`` (numpy only; the port imports
nothing of the JAX package), held equal to it by behaviour in
``tests/test_torch_selection.py``.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

import numpy as np

MAX_NAME_LEN = 8


class NamePool:
    """Bidirectional string <-> code table shared by one column."""

    __slots__ = ("_strings", "_index")

    def __init__(self, strings: Iterable[str] = ()):
        self._strings: list[str] = []
        self._index: dict[str, int] = {}
        for s in strings:
            self.intern(s)

    def intern(self, s: str) -> int:
        if len(s) > MAX_NAME_LEN:
            raise ValueError(f"name does not fit in {MAX_NAME_LEN} bytes: {s!r}")
        code = self._index.get(s)
        if code is None:
            code = len(self._strings)
            self._index[s] = code
            self._strings.append(s)
        return code

    def lookup(self, code: int) -> str:
        return self._strings[code]

    def intern_all(self, strings: Sequence[str]) -> np.ndarray:
        """Vectorized interning of a list of strings -> int32 codes."""
        return np.fromiter((self.intern(s) for s in strings), dtype=np.int32, count=len(strings))

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Codes -> numpy unicode array."""
        table = np.asarray(self._strings, dtype=f"U{MAX_NAME_LEN}")
        return table[np.asarray(codes)]

    def codes_equal(self, s: str) -> int:
        """Code of ``s`` or -1 (never matches) when unseen."""
        return self._index.get(s, -1)

    def codes_matching(self, values: Iterable[str]) -> np.ndarray:
        """Codes whose strings are in ``values`` (unseen values drop out)."""
        out = [self._index[v] for v in values if v in self._index]
        return np.asarray(sorted(out), dtype=np.int32)

    def codes_matching_regex(self, pattern: str) -> np.ndarray:
        """Codes whose string fully matches the anchored regex
        (reference anchors patterns as ^...$, grammar.rs:100-107)."""
        rx = re.compile(pattern)
        return np.asarray(
            [i for i, s in enumerate(self._strings) if rx.fullmatch(s)], dtype=np.int32
        )

    @property
    def strings(self) -> tuple[str, ...]:
        return tuple(self._strings)

    def __len__(self) -> int:
        return len(self._strings)

    def __contains__(self, s: str) -> bool:
        return s in self._index
