"""Per-frame host state, and a window of frames as tensors.

``State`` is the port's copy of ``molar_tpu.core.state.State`` (numpy
only), with :func:`make_fake_state`. :class:`FrameBatch` is the
counterpart of the JAX package's ``FrameBatch`` pytree: the same fields as
torch tensors, moved with :meth:`FrameBatch.to` (no pytree registration).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence

import numpy as np
import torch

from .pbc import PeriodicBox

__all__ = ["State", "FrameBatch", "make_fake_state"]


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

    @property
    def has_velocities(self) -> bool:
        return self.velocities is not None

    @property
    def has_forces(self) -> bool:
        return self.forces is not None

    def require_box(self) -> PeriodicBox:
        if self.box is None:
            raise ValueError("operation requires a periodic box, but state has none")
        return self.box

    def set_box_from(self, src) -> None:
        """Copy the box of ``src`` (System/Sel/State) — molar.pyi:54. A
        fresh PeriodicBox, never an alias."""
        b = src.box if isinstance(src, State) else src.state.box
        self.box = None if b is None else PeriodicBox(b.matrix.copy())

    def copy(self) -> "State":
        return State(
            coords=self.coords.copy(),
            velocities=None if self.velocities is None else self.velocities.copy(),
            forces=None if self.forces is None else self.forces.copy(),
            time=self.time,
            box=self.box,
            step=self.step,
        )


def make_fake_state(n: int, box_side: float = 10.0) -> State:
    """Deterministic fixture state: atom i at (i, i, i), cubic box
    (reference: state.rs:88-96 ``new_fake``)."""
    coords = np.repeat(np.arange(n, dtype=np.float32)[:, None], 3, axis=1)
    box = PeriodicBox(np.diag([box_side, box_side, box_side]).astype(np.float32))
    return State(coords=coords, box=box)


@dataclass
class FrameBatch:
    """A window of B frames as tensors: ``coords`` (B, N, 3), ``boxes`` /
    ``box_invs`` (B, 3, 3), ``times`` (B,), ``valid`` (B,) bool (false on
    the padded tail), ``corrections`` (B, 26, 3) zero-padded, present iff
    a frame's box is triclinic."""

    coords: torch.Tensor
    boxes: torch.Tensor
    box_invs: torch.Tensor
    times: torch.Tensor
    valid: torch.Tensor
    corrections: Optional[torch.Tensor] = None

    @property
    def n_frames(self) -> int:
        return self.coords.shape[0]

    def to(self, device, non_blocking: bool = False) -> "FrameBatch":
        """The same batch with every tensor on ``device``."""
        return FrameBatch(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in fields(self)})

    @staticmethod
    def from_states(states: Sequence[State], pad_to: Optional[int] = None) -> "FrameBatch":
        """Stack host states into one batch on the CPU (``.to(device)`` ships
        it), as the JAX package's ``from_states``: ``pad_to`` frames, the
        tail repeating the last state's coordinates with the identity box,
        time 0 and ``valid`` false; the identity box for a state without
        one."""
        b = len(states)
        n = pad_to or b
        if n < b:
            raise ValueError("pad_to smaller than number of states")
        coords = np.stack([s.coords for s in states])
        if n > b:
            coords = np.concatenate([coords, np.repeat(coords[-1:], n - b, axis=0)])
        eye = np.eye(3, dtype=np.float32)
        boxes = np.stack([s.box.matrix if s.box is not None else eye for s in states]
                         + [eye] * (n - b))
        invs = np.stack([s.box.inv if s.box is not None else eye for s in states]
                        + [eye] * (n - b))
        times = np.array([s.time for s in states] + [0.0] * (n - b), np.float32)
        valid = np.array([True] * b + [False] * (n - b))
        corrections = None
        if any(s.box is not None and s.box.is_triclinic for s in states):
            zero = np.zeros((26, 3), np.float32)
            corrections = torch.from_numpy(np.stack(
                [s.box.padded_corrections() if s.box is not None else zero for s in states]
                + [zero] * (n - b)))
        return FrameBatch(torch.from_numpy(coords.astype(np.float32, copy=False)),
                          torch.from_numpy(boxes.astype(np.float32, copy=False)),
                          torch.from_numpy(invs.astype(np.float32, copy=False)),
                          torch.from_numpy(times), torch.from_numpy(valid), corrections)
