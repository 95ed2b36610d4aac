"""Host (numpy) centers of a selection: the port's copy of
``molar_tpu.ops.measure_host``'s ``center`` and ``center_pbc``, which the
selection language's ``com of`` / ``cog of`` vectors reach.

A PBC-aware center accumulates each point's closest image relative to the
first atom of the selection (measure.rs:142-195), not wrap-then-average;
zero total mass is an error.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.pbc import PBC_FULL, PbcDims, PeriodicBox


class MeasureError(ValueError):
    pass


def _weights(coords: np.ndarray, weights: Optional[np.ndarray]) -> np.ndarray:
    if weights is None:
        return np.ones(coords.shape[0], dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    if w.sum() == 0.0:
        raise MeasureError("zero total mass")
    return w


def center(coords: np.ndarray, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """COM (weights=masses) or COG (weights=None)."""
    w = _weights(coords, weights)
    return (w[:, None] * coords.astype(np.float64)).sum(axis=0) / w.sum()


def center_pbc(
    coords: np.ndarray,
    weights: Optional[np.ndarray],
    box: PeriodicBox,
    pbc: PbcDims = PBC_FULL,
) -> np.ndarray:
    """PBC-aware center: average of closest images relative to atom 0."""
    ref = coords[0]
    imgs = ref + box.shortest_vector(coords - ref, pbc)
    return center(imgs, weights)
