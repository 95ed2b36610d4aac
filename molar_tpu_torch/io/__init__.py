"""IO facade: extension-dispatched file handlers.

The port of ``molar_tpu.io``'s ``FileHandler`` (reference:
molar/src/io.rs:279-782): one entry point that opens any supported format
by extension (``pdb|ent``, ``gro``, ``xyz``, ``xtc``, ``trr``, ``dcd``,
``sdf|sd|mol``, ``itp``, ``nc|ncdf``, ``tpr``, ``cpt``; the reference's
alias table, io.rs:339-377), reads topology/state/both, writes, seeks, and
iterates over trajectory frames.
Iteration prefetches: a reader thread decodes ahead of the consumer through
a bounded queue (the reference's ``IoStateIterator``, io.rs:198-271); the
windowed prefetch pipeline lives in :mod:`molar_tpu_torch.tasks.trajectory`
(``WindowPipeline``). Every handler is imported eagerly and no import or
codec-build error is swallowed (the JAX package's lazy registration drops
a handler whose import fails). Any other extension raises
:class:`FileIoError`.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional

from ..core.state import State
from ..core.topology import Topology
from .base import (
    EmptyFileError,
    FileIoError,
    FileStats,
    FormatHandler,
    MalformedFileError,
    NotReadableError,
    NotWritableError,
    RandomAccessUnsupported,
    SeekError,
)
from .dcd import DcdHandler
from .gro import GroHandler
from .itp import ItpHandler
from .netcdf_amber import NetcdfHandler
from .pdb import PdbHandler
from .sdf import SdfHandler
from .tpr import CptHandler, TprHandler
from .trr import TrrHandler
from .xtc import Frame, XtcHandler
from .xyz import XyzHandler

__all__ = [
    "CptHandler",
    "DcdHandler",
    "FileHandler",
    "Frame",
    "handler_factory",
    "GroHandler",
    "ItpHandler",
    "NetcdfHandler",
    "PdbHandler",
    "SdfHandler",
    "TprHandler",
    "TrrHandler",
    "XtcHandler",
    "XyzHandler",
    "open_file",
    "read_file",
    "register_format",
    "FileIoError",
    "EmptyFileError",
    "MalformedFileError",
    "NotReadableError",
    "NotWritableError",
    "SeekError",
    "RandomAccessUnsupported",
    "FileStats",
    "FormatHandler",
]

_REGISTRY: dict[str, Callable[[str, str], FormatHandler]] = {}


def register_format(extensions: str, factory: Callable[[str, str], FormatHandler]) -> None:
    """Register a handler factory for '|'-separated extensions."""
    for ext in extensions.split("|"):
        _REGISTRY[ext.lower()] = factory


register_format("pdb|ent", PdbHandler)
register_format("gro", GroHandler)
register_format("xyz", XyzHandler)
register_format("xtc", XtcHandler)
register_format("trr", TrrHandler)
register_format("dcd", DcdHandler)
register_format("sdf|sd|mol", SdfHandler)
register_format("itp", ItpHandler)
register_format("nc|ncdf", NetcdfHandler)
register_format("tpr", TprHandler)
register_format("cpt", CptHandler)


def handler_factory(path: str) -> Callable[[str, str], FormatHandler]:
    """The registered handler factory for ``path``'s extension; raises
    :class:`FileIoError` for any other."""
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    factory = _REGISTRY.get(ext)
    if factory is None:
        raise FileIoError(f"unsupported file extension: {ext!r} ({path})")
    return factory


class FileHandler:
    """Extension-dispatched facade with timing stats and frame iteration."""

    def __init__(self, path: str, mode: str = "r"):
        factory = handler_factory(path)
        self.path = path
        self.mode = mode
        self.stats = FileStats()
        self.handler = factory(path, mode)
        self._pushback: Optional[State] = None

    @classmethod
    def from_reader(cls, reader, fmt: str) -> "FileHandler":
        """Open a read handler over a non-file source (io.rs:396-422).

        ``reader`` is any object with ``read()`` returning bytes or str (a
        BytesIO/StringIO, a socket file, a download blob...). Because several
        binary decoders are mmap/seek based, the stream is spooled to an
        anonymous temp file that is unlinked as soon as the handler has opened
        it — no path leaks to the caller and the data lives only for the
        handler's lifetime. ``fmt`` names the format ("pdb", "xtc", ...)
        since there is no file extension to dispatch on.
        """
        import tempfile

        data = reader.read()
        if isinstance(data, str):
            data = data.encode()
        tmp = tempfile.NamedTemporaryFile(suffix="." + fmt.lstrip("."), delete=False)
        try:
            tmp.write(data)
            tmp.close()
            fh = cls(tmp.name, "r")
        finally:
            try:
                os.unlink(tmp.name)
            except OSError:
                pass
        return fh

    # -- reads -----------------------------------------------------------------

    def read(self) -> tuple[Topology, State]:
        with self.stats.timed():
            top, st = self.handler.read()
        self.stats.frames_processed += 1
        self.stats.cur_t = st.time
        return top, st

    def read_topology(self) -> Topology:
        with self.stats.timed():
            return self.handler.read_topology()

    def read_state(self) -> Optional[State]:
        if self._pushback is not None:
            st, self._pushback = self._pushback, None
            return st
        with self.stats.timed():
            st = self.handler.read_state()
        if st is not None:
            self.stats.frames_processed += 1
            self.stats.cur_t = st.time
        return st

    def read_state_pick(self, need_velocities=True, need_forces=True) -> Optional[State]:
        with self.stats.timed():
            st = self.handler.read_state_pick(need_velocities, need_forces)
        if st is not None:
            self.stats.frames_processed += 1
            self.stats.cur_t = st.time
        return st

    # -- writes ----------------------------------------------------------------

    def write(self, topology: Topology, state: State, indices=None) -> None:
        with self.stats.timed():
            self.handler.write(topology, state, indices)
        self.stats.frames_processed += 1

    def write_system(self, system, indices=None) -> None:
        self.write(system.topology, system.state, indices)

    def write_topology(self, data) -> None:
        """Write only the topology part of ``data`` (System/Sel/Topology) —
        pymolar molar.pyi:95. Coordinate-carrying formats write the current
        state alongside (as the reference's topology writers do)."""
        if isinstance(data, Topology):
            from ..core.state import make_fake_state

            self.write(data, make_fake_state(len(data)))
            return
        idx = getattr(data, "indices", None)
        self.write(data.topology, data.state, idx)

    def write_state(self, data) -> None:
        """Write only the state/frame part of ``data`` (System/Sel/State) —
        pymolar molar.pyi:96. A bare State can only go to trajectory
        formats; structure formats need atom records."""
        if isinstance(data, State):
            try:
                self.write(None, data)
            except AttributeError:
                raise FileIoError(
                    f"{self.path}: this format needs a topology to write — "
                    "pass a System/Sel, or use a trajectory format "
                    "(xtc/trr/dcd) for bare states"
                ) from None
            return
        idx = getattr(data, "indices", None)
        self.write(data.topology, data.state, idx)

    def write_state_pick(
        self,
        state: State,
        indices=None,
        write_coords: bool = True,
        write_velocities: bool = True,
        write_forces: bool = True,
    ) -> None:
        """Write a state skipping vel/forces at the IO level (io.rs
        write_state_pick). Formats whose handler lacks native pick support
        get a filtered copy."""
        h = self.handler
        with self.stats.timed():
            if hasattr(h, "write_state"):
                h.write_state(
                    state,
                    indices,
                    write_coords=write_coords,
                    write_velocities=write_velocities,
                    write_forces=write_forces,
                )
            else:
                import dataclasses

                filtered = dataclasses.replace(
                    state,
                    velocities=state.velocities if write_velocities else None,
                    forces=state.forces if write_forces else None,
                )
                h.write(None, filtered, indices)
        self.stats.frames_processed += 1

    # -- random access ---------------------------------------------------------

    def seek_frame(self, fr: int) -> None:
        self.handler.seek_frame(fr)

    def seek_time(self, t: float) -> None:
        self.handler.seek_time(t)

    def seek_last(self) -> State:
        return self.handler.seek_last()

    def skip_to_frame(self, fr: int) -> None:
        """Random access with serial fallback (io.rs:726-769)."""
        try:
            self.handler.seek_frame(fr)
        except RandomAccessUnsupported:
            for _ in range(fr):
                if self.read_state() is None:
                    raise SeekError(f"frame {fr} beyond end of {self.path}")

    def skip_to_time(self, t: float) -> None:
        try:
            self.handler.seek_time(t)
        except RandomAccessUnsupported:
            while True:
                st = self.read_state()
                if st is None:
                    raise SeekError(f"time {t} beyond end of {self.path}")
                if st.time >= t:
                    # Reference semantics: stop at first frame with time >= t;
                    # that frame is consumed here, matching skip_to_time's
                    # "position before next read" contract loosely.
                    self._pushback = st
                    break

    # -- iteration -------------------------------------------------------------

    def __iter__(self) -> Iterator[State]:
        return self.iter_states()

    def iter_states(self, prefetch: int = 10) -> Iterator[State]:
        """Iterate frames, decoding ahead of the consumer.

        With ``prefetch > 0`` (default) a reader thread decodes up to that
        many frames ahead through a bounded queue — the reference's
        ``IoStateIterator`` shape (io.rs:198-271: reader thread +
        ``sync_channel(10)``), so per-frame analysis overlaps with decode
        when the consumer blocks off-CPU (device dispatch, downstream IO).
        ``prefetch=0`` reads synchronously. While an iterator is live it
        owns the handler's read cursor — interleaving ``seek_*``/
        ``read_state`` calls with iteration is undefined, as in the
        reference.
        """
        if prefetch <= 0:
            yield from self._iter_sync()
            return
        import queue as _queue
        import threading

        q: _queue.Queue = _queue.Queue(maxsize=prefetch)
        stop = threading.Event()
        _END = object()

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def feeder() -> None:
            try:
                for st in self._iter_sync():
                    if not put_or_stop(st):
                        return
                put_or_stop(_END)
            except BaseException as e:  # propagate to the consumer
                put_or_stop(e)

        t = threading.Thread(target=feeder, daemon=True, name="molar-io-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Join before returning: the consumer's next move may be
            # close(), and an in-flight read_state on the feeder thread
            # racing a close() corrupts/leaks the mmap. put_or_stop polls
            # ``stop`` every 0.1 s, so this returns promptly.
            t.join()

    def _iter_sync(self) -> Iterator[State]:
        while True:
            try:
                st = self.read_state()
            except (FileIoError, EOFError) as e:
                # A corrupt tail terminates iteration with a warning, not a
                # crash (io.rs:254-269).
                import logging

                logging.getLogger(__name__).warning(
                    "trajectory %s terminated early: %s", self.path, e
                )
                return
            if st is None:
                return
            yield st

    def close(self) -> None:
        # Print accumulated IO timing on close (reference FileStats-on-drop,
        # io.rs:286-306, 784-792).
        if self.stats.frames_processed:
            import logging

            logging.getLogger(__name__).debug(
                "%s: %d frames in %.3fs of IO (t=%.2f ps)",
                self.path,
                self.stats.frames_processed,
                self.stats.elapsed_time,
                self.stats.cur_t,
            )
        self.handler.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def open_file(path: str, mode: str = "r") -> FileHandler:
    return FileHandler(path, mode)


def read_file(path: str) -> tuple[Topology, State]:
    """One-shot topology+state read (System::from_file's engine)."""
    with FileHandler(path) as fh:
        return fh.read()
