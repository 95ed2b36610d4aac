"""What decides ``correct``: numbers compared, each with its limit, and the
comparisons of selected atom sets against the reference."""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np

#: The most atoms a frame may have in the undecidable band before the
#: enumeration of their subsets is refused (2^16 subsets).
MAX_BAND = 16


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def digest(idx: np.ndarray) -> tuple[int, int]:
    """(count, sum(idx + 1) mod 2^32): the headline's membership checksum."""
    idx = np.asarray(idx, np.int64)
    return len(idx), int((idx + 1).sum() % (1 << 32))


def digest_matches(count: int, check: int, sure: np.ndarray, band: np.ndarray) -> bool:
    """Whether the program's (count, checksum) is that of ``sure`` plus some
    subset of ``band`` (atoms within rounding of the cutoff, which float32
    arithmetic may decide either way)."""
    base_n, base_c = digest(np.setdiff1d(sure, band))
    if len(band) > MAX_BAND:
        return False
    for k in range(len(band) + 1):
        if base_n + k != count:
            continue
        for sub in itertools.combinations(np.asarray(band, np.int64), k):
            if (base_c + sum(int(i) + 1 for i in sub)) % (1 << 32) == check:
                return True
    return False


def set_mismatch(got: np.ndarray, sure: np.ndarray, band: np.ndarray) -> int:
    """Atoms on which ``got`` and the reference set ``sure`` differ, outside
    the undecidable ``band``."""
    diff = np.setxor1d(np.asarray(got, np.int64), np.asarray(sure, np.int64))
    return int(len(np.setdiff1d(diff, band)))


def sample(seed: int, population: int, k: int) -> np.ndarray:
    """``k`` distinct members of ``range(population)`` drawn from ``seed``
    (the first and last always in), sorted."""
    if population <= max(k, 2):
        return np.arange(population)
    rng = np.random.default_rng([seed % (1 << 63), 0x5EED])
    inner = rng.choice(np.arange(1, population - 1), size=k - 2, replace=False)
    return np.sort(np.concatenate([[0, population - 1], inner]))
