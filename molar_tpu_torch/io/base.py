"""Format-handler protocol and IO error taxonomy.

The reference exposes a ``FileFormatHandler`` vtable trait plus a rich
``FileFormatError`` taxonomy (molar/src/io.rs:120-191, 824-926). Here, handlers
are plain classes implementing :class:`FormatHandler`; end-of-trajectory is the
``None`` return of :meth:`read_state` (instead of an Eof error), malformed data
raises.

Writers take ``(topology, state, indices)`` — ``indices=None`` means all atoms,
otherwise the caller passes a selection's index array, which is how "write this
selection to a file" works without materializing a sub-system.

The port's copy of ``molar_tpu.io.base``.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.state import State
from ..core.topology import Topology


class FileIoError(RuntimeError):
    """Base for all file-format errors."""


class EmptyFileError(FileIoError):
    pass


class MalformedFileError(FileIoError):
    pass


class NotWritableError(FileIoError):
    pass


class NotReadableError(FileIoError):
    pass


class SeekError(FileIoError):
    pass


class RandomAccessUnsupported(SeekError):
    pass


@dataclass
class FileStats:
    """Accumulated IO timing, printed by the facade on close
    (reference: io.rs:286-306)."""

    elapsed_time: float = 0.0  # seconds inside IO calls
    frames_processed: int = 0
    cur_t: float = 0.0  # time of the last frame seen (ps)

    def timed(self):
        return _Timer(self)


class _Timer:
    def __init__(self, stats: FileStats):
        self.stats = stats

    def __enter__(self):
        self._t0 = _time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stats.elapsed_time += _time.perf_counter() - self._t0
        return False


class FormatHandler:
    """Base class for all file-format handlers.

    Single-frame structure formats (PDB/GRO read ``(Topology, State)``
    together); trajectory formats usually implement only state reads.
    Default implementations raise/return sensible "unsupported".
    """

    #: class attrs describing capabilities
    can_read_topology = False
    can_read_state = False
    can_write = False
    can_seek = False

    def read(self) -> tuple[Topology, State]:
        """Read topology and state together (only PDB/GRO/TPR support this;
        io.rs read() contract)."""
        raise NotReadableError(f"{type(self).__name__} cannot read topology+state")

    def read_topology(self) -> Topology:
        raise NotReadableError(f"{type(self).__name__} cannot read a topology")

    def read_state(self) -> Optional[State]:
        """Next frame, or ``None`` at end of trajectory."""
        raise NotReadableError(f"{type(self).__name__} cannot read states")

    def read_state_pick(self, need_velocities: bool = True, need_forces: bool = True) -> Optional[State]:
        """Like read_state but may skip decoding velocity/force blocks at the IO
        level (io.rs ``read_state_pick``). Default: plain read + drop."""
        st = self.read_state()
        if st is None:
            return None
        if not need_velocities:
            st.velocities = None
        if not need_forces:
            st.forces = None
        return st

    def write(
        self,
        topology: Topology,
        state: State,
        indices: Optional[np.ndarray] = None,
    ) -> None:
        raise NotWritableError(f"{type(self).__name__} cannot write")

    # -- random access ------------------------------------------------------

    def seek_frame(self, fr: int) -> None:
        raise RandomAccessUnsupported(type(self).__name__)

    def seek_time(self, t: float) -> None:
        raise RandomAccessUnsupported(type(self).__name__)

    def seek_last(self) -> State:
        raise RandomAccessUnsupported(type(self).__name__)

    def tell_first(self) -> tuple[int, float]:
        """(frame, time) of the first frame, for seek math."""
        raise RandomAccessUnsupported(type(self).__name__)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def apply_indices(
    topology: Topology, state: State, indices: Optional[np.ndarray]
) -> tuple[Topology, State]:
    """Resolve the (topology, state, indices) writer triple to concrete data."""
    if indices is None:
        return topology, state
    idx = np.asarray(indices)
    sub_top = topology.subset(idx)
    sub_state = State(
        coords=state.coords[idx],
        velocities=None if state.velocities is None else state.velocities[idx],
        forces=None if state.forces is None else state.forces[idx],
        time=state.time,
        box=state.box,
        step=state.step,
    )
    return sub_top, sub_state
