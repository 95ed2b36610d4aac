"""TPR / CPT handlers via the dlopen'd GROMACS plugin.

The port's copy of ``molar_tpu.io.tpr``. GROMACS has no stable file-format
library ABI, so, like the reference (molar_gromacs/src/lib.rs:44-189,
io/tpr_handler.rs, io/cpt_handler.rs), these handlers call into a
per-installation C++ shim (``molar_tpu/native/gromacs_plugin.cpp``, compiled
by path with ``python -m molar_tpu_torch.build gromacs-plugin``) located via,
in order:

1. the ``MOLAR_GROMACS_PLUGIN`` env var (runtime override);
2. ``build/molar_tpu_torch/libmolar_gromacs.so`` (the build default);
3. failing both, the pure tpx/CPT decoder of :mod:`.tpx`, which needs no
   GROMACS installation (GROMACS 2020+ files).

TPR yields (Topology with type names/ids, bonds, molecules; State with
coords + box); single-frame semantics (a second read ends iteration). CPT
yields a State with coords/velocities/forces/box/time/step.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from typing import Optional

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..core.atom import Atom
from ..core.pbc import PeriodicBox, PeriodicBoxError
from ..core.state import State
from ..core.topology import Topology
from .. import build
from .base import FileIoError, FormatHandler


class GromacsPluginError(FileIoError):
    pass


@lru_cache(maxsize=1)
def _plugin() -> ctypes.CDLL:
    cands = []
    env = os.environ.get("MOLAR_GROMACS_PLUGIN")
    if env:
        cands.append(env)
    cands.append(str(build.GROMACS_PLUGIN))
    for c in cands:
        if os.path.exists(c):
            lib = ctypes.CDLL(c)
            _declare(lib)
            return lib
    raise GromacsPluginError(
        "GROMACS plugin not found. Build it with "
        "`python -m molar_tpu_torch.build gromacs-plugin` against your "
        "GROMACS tree (GROMACS_SOURCE_DIR/GROMACS_BUILD_DIR/GROMACS_LIB_DIR), "
        "or point MOLAR_GROMACS_PLUGIN at the built library."
    )


def _declare(lib: ctypes.CDLL) -> None:
    c_p = ctypes.c_void_p
    lib.molar_gmx_last_error.restype = ctypes.c_char_p
    lib.tpr_open.restype = c_p
    lib.tpr_open.argtypes = [ctypes.c_char_p]
    lib.cpt_open.restype = c_p
    lib.cpt_open.argtypes = [ctypes.c_char_p]
    for name in ("tpr_natoms", "tpr_nbonds", "tpr_nmolecules", "cpt_natoms", "cpt_step"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [c_p]
    lib.cpt_time.restype = ctypes.c_double
    lib.cpt_time.argtypes = [c_p]
    # Every remaining entry point takes the opaque handle first; without an
    # explicit c_void_p argtype ctypes would pass the Python int as a C int,
    # truncating 64-bit pointers (segfault caught by the mock-.so test).
    for name in ("tpr_close", "cpt_close"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [c_p]
    for name in ("cpt_has_velocities", "cpt_has_forces"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [c_p]
    for name in (
        "tpr_get_names",
        "tpr_get_resnames",
        "tpr_get_type_names",
        "tpr_get_resid",
        "tpr_get_type_id",
        "tpr_get_atomic_number",
        "tpr_get_charge",
        "tpr_get_mass",
        "tpr_get_bonds",
        "tpr_get_molecules",
        "tpr_get_coords",
        "tpr_get_box",
        "cpt_get_coords",
        "cpt_get_velocities",
        "cpt_get_forces",
        "cpt_get_box",
    ):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [c_p, c_p]


def _np_out(lib_fn, handle, arr: np.ndarray) -> np.ndarray:
    lib_fn(handle, arr.ctypes.data_as(ctypes.c_void_p))
    return arr


def _decode_names(raw: np.ndarray) -> list[str]:
    return [
        bytes(raw[i * 8 : (i + 1) * 8]).split(b"\0")[0].decode("ascii", "replace")
        for i in range(len(raw) // 8)
    ]


def _box_from_rows(box9: np.ndarray) -> Optional[PeriodicBox]:
    m = box9.reshape(3, 3).T  # GROMACS rows -> our columns
    if not m.any():
        return None
    try:
        return PeriodicBox(m)
    except PeriodicBoxError:
        return None


class TprHandler(FormatHandler):
    can_read_topology = True
    can_read_state = True

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise FileIoError("tpr files are read-only")
        self.path = path
        self._native = None
        try:
            lib = _plugin()
            h = lib.tpr_open(path.encode())
            if not h:
                raise GromacsPluginError(
                    f"tpr_open failed: {lib.molar_gmx_last_error().decode()}"
                )
        except Exception as plugin_err:
            # No libgromacs on this machine (or it failed to open): fall
            # back to the pure native tpx decoder (io/tpx.py), which covers
            # GROMACS 2020+ files without any GROMACS installation.
            from .tpx import TpxError, TpxNativeHandler

            try:
                self._native = TpxNativeHandler(path)
            except (TpxError, OSError):
                raise plugin_err
            self._lib = None
            self._h = None
            return
        self._lib = lib
        self._h = h
        self._read_any = False
        self._stored_topology: Optional[Topology] = None
        self._stored_state: Optional[State] = None

    def __getattribute__(self, name):
        # Delegate the handler surface to the native fallback when active.
        native = object.__getattribute__(self, "__dict__").get("_native")
        if native is not None and name in (
            "read", "read_topology", "read_state", "iter_states", "close",
        ):
            return getattr(native, name)
        return object.__getattribute__(self, name)

    def close(self) -> None:
        if self._h:
            self._lib.tpr_close(self._h)
            self._h = None

    def read(self) -> tuple[Topology, State]:
        if self._read_any:
            raise EOFError("tpr is single-frame")
        lib, h = self._lib, self._h
        n = lib.tpr_natoms(h)
        nb = lib.tpr_nbonds(h)
        nm = lib.tpr_nmolecules(h)
        names = _decode_names(_np_out(lib.tpr_get_names, h, np.zeros(n * 8, np.uint8)))
        resnames = _decode_names(
            _np_out(lib.tpr_get_resnames, h, np.zeros(n * 8, np.uint8))
        )
        type_names = _decode_names(
            _np_out(lib.tpr_get_type_names, h, np.zeros(n * 8, np.uint8))
        )
        resid = _np_out(lib.tpr_get_resid, h, np.zeros(n, np.int32))
        type_id = _np_out(lib.tpr_get_type_id, h, np.zeros(n, np.int32))
        z = _np_out(lib.tpr_get_atomic_number, h, np.zeros(n, np.int32))
        charge = _np_out(lib.tpr_get_charge, h, np.zeros(n, np.float32))
        mass = _np_out(lib.tpr_get_mass, h, np.zeros(n, np.float32))
        atoms = [
            Atom(
                name=names[i][:8],
                resname=resnames[i][:8],
                resid=int(resid[i]),
                atomic_number=int(z[i]),
                charge=float(charge[i]),
                mass=float(mass[i]),
                type_name=type_names[i][:8],
                type_id=int(type_id[i]),
            )
            for i in range(n)
        ]
        top = Topology.from_atoms(atoms)
        if nb:
            bonds = _np_out(lib.tpr_get_bonds, h, np.zeros(nb * 2, np.uint32))
            top.set_bonds(bonds.reshape(-1, 2).astype(np.int64))
        if nm:
            mols = _np_out(lib.tpr_get_molecules, h, np.zeros(nm * 2, np.uint32))
            top.molecules = mols.reshape(-1, 2).astype(np.int32)
        top.assign_resindex()
        coords = _np_out(lib.tpr_get_coords, h, np.zeros(n * 3, np.float32)).reshape(
            -1, 3
        )
        box9 = _np_out(lib.tpr_get_box, h, np.zeros(9, np.float32))
        self._read_any = True
        return top, State(coords=coords.astype(FLOAT), box=_box_from_rows(box9))

    def read_topology(self) -> Topology:
        if self._stored_topology is not None:
            t, self._stored_topology = self._stored_topology, None
            return t
        top, st = self.read()
        self._stored_state = st
        return top

    def read_state(self) -> Optional[State]:
        if self._stored_state is not None:
            s, self._stored_state = self._stored_state, None
            return s
        try:
            top, st = self.read()
        except EOFError:
            return None
        self._stored_topology = top
        return st


class CptHandler(FormatHandler):
    can_read_state = True

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise FileIoError("cpt files are read-only")
        self.path = path
        self._native = None
        try:
            lib = _plugin()
            h = lib.cpt_open(path.encode())
            if not h:
                raise GromacsPluginError(
                    f"cpt_open failed: {lib.molar_gmx_last_error().decode()}"
                )
        except Exception as plugin_err:
            from .tpx import CptNativeHandler, TpxError

            try:
                self._native = CptNativeHandler(path)
            except (TpxError, OSError):
                raise plugin_err
            self._lib = None
            self._h = None
            return
        self._lib = lib
        self._h = h
        self._read_any = False

    def __getattribute__(self, name):
        native = object.__getattribute__(self, "__dict__").get("_native")
        if native is not None and name in (
            "read_state", "iter_states", "close",
        ):
            return getattr(native, name)
        return object.__getattribute__(self, name)

    def close(self) -> None:
        if self._h:
            self._lib.cpt_close(self._h)
            self._h = None

    def read_state(self) -> Optional[State]:
        if self._read_any:
            return None
        lib, h = self._lib, self._h
        n = lib.cpt_natoms(h)
        coords = _np_out(lib.cpt_get_coords, h, np.zeros(n * 3, np.float32)).reshape(
            -1, 3
        )
        vel = force = None
        if lib.cpt_has_velocities(h):
            vel = _np_out(
                lib.cpt_get_velocities, h, np.zeros(n * 3, np.float32)
            ).reshape(-1, 3)
        if lib.cpt_has_forces(h):
            force = _np_out(lib.cpt_get_forces, h, np.zeros(n * 3, np.float32)).reshape(
                -1, 3
            )
        box9 = _np_out(lib.cpt_get_box, h, np.zeros(9, np.float32))
        self._read_any = True
        return State(
            coords=coords.astype(FLOAT),
            velocities=vel,
            forces=force,
            time=float(lib.cpt_time(h)),
            step=int(lib.cpt_step(h)),
            box=_box_from_rows(box9),
        )
