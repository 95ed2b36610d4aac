"""Per-frame host state: coordinates, velocities, forces, time, box.

The port's copy of ``molar_tpu.core.state.State`` (numpy only). The JAX
package's ``FrameBatch`` pytree has no counterpart here: a window of frames
is plain ``(B, N, 3)`` / ``(B, 3, 3)`` tensors on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .pbc import PeriodicBox

__all__ = ["State"]


@dataclass
class State:
    coords: np.ndarray  # (N, 3) f32
    velocities: Optional[np.ndarray] = None  # (N, 3) or None
    forces: Optional[np.ndarray] = None  # (N, 3) or None
    time: float = 0.0  # ps
    box: Optional[PeriodicBox] = None
    step: int = 0

    @property
    def n_atoms(self) -> int:
        return self.coords.shape[0]

    def __len__(self) -> int:
        return self.n_atoms

    def require_box(self) -> PeriodicBox:
        if self.box is None:
            raise ValueError("operation requires a periodic box, but state has none")
        return self.box
