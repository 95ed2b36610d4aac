"""System and Sel: the user-facing data + selection API.

The port's copy of ``molar_tpu.core.system`` (numpy only). ``System`` owns a
(Topology, State) pair with a size invariant (reference:
molar/src/selection/system.rs:11-22). ``Sel`` is a *bound* selection — a
sorted, non-empty global index array plus a reference to its system
(reference sel.rs:10-19: empty selections are an error, not an empty set).

``Sel``'s measures run on host numpy by design (:mod:`molar_tpu_torch.ops.measure_host`):
below ~1e6 operations a call numpy beats a launch. The card enters where a
selection feeds a window: ``sel.indices`` / ``sel.coords`` / ``sel.masses``
into :class:`~molar_tpu_torch.tasks.trajectory.WindowPipeline`, a selection
text into :class:`~molar_tpu_torch.selection.FrameSelection`. Ring
perception (:mod:`~molar_tpu_torch.ops.perception`), GAFF typing
(:mod:`~molar_tpu_torch.ff.gaff`) and surface meshes
(:mod:`~molar_tpu_torch.ops.surface`) are host work too.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..selection import SelectionExpr
from .pbc import PBC_FULL, PBC_NONE, PbcDims, PeriodicBox
from .state import State
from .topology import Topology


class SelectionError(ValueError):
    pass


SelectionDef = Union[str, SelectionExpr, np.ndarray, Sequence[int], range, slice, "Sel"]


def _is_range_tuple(seldef) -> bool:
    """The pymolar 2-tuple RANGE form: two real ints (bools excluded —
    isinstance(True, int) holds, but (True, 3) is an index pair, not a
    range)."""
    return (
        isinstance(seldef, tuple)
        and len(seldef) == 2
        and all(
            isinstance(v, (int, np.integer)) and not isinstance(v, bool)
            for v in seldef
        )
    )


class System:
    """Owns a topology and the current state; selections bind to it."""

    def __init__(
        self,
        topology: "Topology | str | None" = None,
        state: Optional[State] = None,
    ):
        # pymolar constructor overloads (molar.pyi:110-114): System(),
        # System("file.pdb"), System(topology, state).
        if isinstance(topology, str):
            if state is not None:
                raise SelectionError(
                    "System(filename) takes no state argument"
                )
            from ..io import read_file

            topology, state = read_file(topology)
        elif topology is None and state is None:
            topology = Topology.from_atoms([])
            state = State(coords=np.zeros((0, 3), FLOAT))
        elif topology is None or state is None:
            raise SelectionError(
                "System takes no arguments, a filename, or BOTH a topology "
                "and a state"
            )
        if topology.n_atoms != state.n_atoms:
            raise SelectionError(
                f"topology has {topology.n_atoms} atoms but state has {state.n_atoms}"
            )
        self.topology = topology
        self.state = state

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_file(path: str) -> "System":
        from ..io import read_file

        top, st = read_file(str(path))
        return System(top, st)

    # -- basic accessors ------------------------------------------------------

    @property
    def n_atoms(self) -> int:
        return self.topology.n_atoms

    def __len__(self) -> int:
        return self.n_atoms

    @property
    def box(self) -> Optional[PeriodicBox]:
        return self.state.box

    @property
    def time(self) -> float:
        return self.state.time

    def set_state(self, state: State) -> State:
        """Swap in a new state (same atom count), returning the old one —
        the per-frame hot path of the analysis loop (system.rs:230)."""
        if state.n_atoms != self.n_atoms:
            raise SelectionError(
                f"state has {state.n_atoms} atoms, system has {self.n_atoms}"
            )
        old, self.state = self.state, state
        return old

    # -- selections ------------------------------------------------------------

    def _resolve_def(self, seldef: SelectionDef, subset: Optional[np.ndarray] = None) -> np.ndarray:
        n = self.n_atoms
        if seldef is None:
            # pymolar: System(None) / System() select every atom
            # (molar.pyi:117).
            idx = np.arange(n, dtype=np.int64)
            if subset is not None:
                idx = np.asarray(subset, dtype=np.int64).copy()
            return idx
        if _is_range_tuple(seldef):
            # pymolar: a 2-tuple is the RANGE form (molar.pyi:117),
            # half-open [start, stop) like Python ranges; explicit index
            # LISTS stay the list form below.
            idx = np.arange(seldef[0], seldef[1], dtype=np.int64)
        elif isinstance(seldef, Sel):
            idx = seldef.indices.copy()
        elif isinstance(seldef, SelectionExpr):
            idx = seldef.apply(self.topology, self.state, subset)
        elif isinstance(seldef, str):
            idx = SelectionExpr(seldef).apply(self.topology, self.state, subset)
        elif isinstance(seldef, range):
            idx = np.arange(seldef.start, seldef.stop, seldef.step, dtype=np.int64)
        elif isinstance(seldef, slice):
            idx = np.arange(*seldef.indices(n), dtype=np.int64)
        else:
            idx = np.unique(np.asarray(seldef, dtype=np.int64))
        if len(idx) == 0:
            raise SelectionError(f"selection is empty: {seldef!r}")
        if idx.min() < 0 or idx.max() >= n:
            raise SelectionError(
                f"selection index out of bounds (0..{n - 1}): {seldef!r}"
            )
        if subset is not None and not isinstance(seldef, (str, SelectionExpr)):
            sub = np.asarray(subset)
            if not np.isin(idx, sub).all():
                raise SelectionError("sub-selection indices escape the parent selection")
        return idx

    def select(self, seldef: SelectionDef = None) -> "Sel":
        return Sel(self, self._resolve_def(seldef))

    def select_indices(self, text: str) -> np.ndarray:
        """Sorted atom indices of a selection text on the current state
        (host evaluator); empty where nothing matches."""
        return SelectionExpr(text).apply(self.topology, self.state)

    __call__ = select

    def select_all(self) -> "Sel":
        return Sel(self, np.arange(self.n_atoms, dtype=np.int64))

    def bind(self, sel: "Sel") -> "Sel":
        """Bind another system's selection (same index set) to this system —
        the `&sel >> &sys` operator of the reference (system.rs:422-435);
        one bounds check."""
        idx = sel.indices
        if len(idx) and idx[-1] >= self.n_atoms:
            raise SelectionError(
                f"selection max index {idx[-1]} out of bounds for system of "
                f"{self.n_atoms} atoms"
            )
        return Sel(self, idx.copy())

    # -- editing ----------------------------------------------------------------

    def append_atoms(
        self,
        atoms,
        coords: np.ndarray,
        velocities: Optional[np.ndarray] = None,
    ) -> "Sel":
        """Append atoms (list of Atom) with coordinates, returning the
        selection of the added atoms (system.rs:272; the reference returns
        it so callers can e.g. ``set_same_resname`` on what they added —
        README tutorial)."""
        n_before = self.n_atoms
        add = Topology.from_atoms(list(atoms))
        self.topology = self.topology.concat(add)
        self.state.coords = np.concatenate(
            [self.state.coords, np.asarray(coords, FLOAT).reshape(-1, 3)]
        )
        if self.state.velocities is not None:
            v = (
                np.asarray(velocities, FLOAT).reshape(-1, 3)
                if velocities is not None
                else np.zeros((add.n_atoms, 3), FLOAT)
            )
            self.state.velocities = np.concatenate([self.state.velocities, v])
        if self.state.forces is not None:
            self.state.forces = np.concatenate(
                [self.state.forces, np.zeros((add.n_atoms, 3), FLOAT)]
            )
        return Sel(self, np.arange(n_before, self.n_atoms, dtype=np.int64))

    def append(self, what: Union["System", "Sel"]) -> None:
        """Append a System or a Sel — including a selection of this same
        system (reference append_from_self, system.rs:272). The source is
        snapshotted first, so self-appends are safe."""
        if isinstance(what, Sel):
            what = what.to_system()
        self.append_system(what)

    def append_system(self, other: "System") -> None:
        n_add = other.n_atoms
        self.topology = self.topology.concat(other.topology)
        self.state.coords = np.concatenate([self.state.coords, other.state.coords])
        # Optional per-atom arrays keep self's presence: appended atoms
        # without data are zero-padded rather than silently dropping the
        # whole column (keeps remove()/keep() indexing aligned).
        for field in ("velocities", "forces"):
            mine = getattr(self.state, field)
            if mine is None:
                continue
            theirs = getattr(other.state, field)
            if theirs is None:
                theirs = np.zeros((n_add, 3), FLOAT)
            setattr(self.state, field, np.concatenate([mine, theirs]))

    def remove(self, seldef: SelectionDef) -> None:
        idx = self._resolve_def(seldef)
        keep = np.ones(self.n_atoms, dtype=bool)
        keep[idx] = False
        kept = np.nonzero(keep)[0]
        self.topology = self.topology.subset(kept)
        self.state.coords = self.state.coords[kept]
        if self.state.velocities is not None:
            self.state.velocities = self.state.velocities[kept]
        if self.state.forces is not None:
            self.state.forces = self.state.forces[kept]

    def keep(self, seldef: SelectionDef) -> None:
        idx = self._resolve_def(seldef)
        self.topology = self.topology.subset(idx)
        self.state.coords = self.state.coords[idx]
        if self.state.velocities is not None:
            self.state.velocities = self.state.velocities[idx]
        if self.state.forces is not None:
            self.state.forces = self.state.forces[idx]

    def replace_state_deep(self, state: State) -> None:
        """Swap state CONTENTS with the currently-held state object
        (reference replace_state_deep): every existing reference to the old
        State object — including `state` itself — observes the exchange."""
        if state.n_atoms != self.n_atoms:
            raise SelectionError(
                f"state has {state.n_atoms} atoms, system has {self.n_atoms}"
            )
        cur = self.state
        for f in ("coords", "velocities", "forces", "time", "box", "step"):
            a, b = getattr(cur, f), getattr(state, f)
            setattr(cur, f, b)
            setattr(state, f, a)

    def set_box_from(self, other: "System") -> None:
        """Copy the periodic box from another system (system.rs set_box_from).

        A fresh PeriodicBox is made so later mutations of either system's box
        don't alias the other.
        """
        b = other.state.box
        self.state.box = None if b is None else PeriodicBox(b.matrix.copy())

    def iter_pos(self):
        """Yield each atom's position row (pymolar molar.pyi:126)."""
        for row in self.state.coords:
            yield row

    def iter_atoms(self):
        """Yield each atom as an :class:`Atom` (pymolar molar.pyi:127)."""
        for i in range(self.n_atoms):
            yield self.topology.atom(i)

    def multiply_periodically(self, nx: int, ny: int, nz: int) -> None:
        """Tile the system nx*ny*nz times along the box vectors, scaling the
        box accordingly (system.rs:312; the solvate workhorse)."""
        box = self.state.require_box()
        reps = [
            (i, j, k)
            for i in range(nx)
            for j in range(ny)
            for k in range(nz)
        ]
        if len(reps) <= 1:
            return
        base_top = self.topology
        base_coords = self.state.coords
        m = box.matrix
        tops = base_top
        coords = [base_coords]
        for (i, j, k) in reps[1:]:
            shift = (i * m[:, 0] + j * m[:, 1] + k * m[:, 2]).astype(FLOAT)
            tops = tops.concat(base_top)
            coords.append(base_coords + shift)
        self.topology = tops
        # Re-run resindex assignment over the tiled topology: raw concat
        # repeats each tile's resindex values, which breaks per-residue
        # filtering downstream (reference system.rs:312-340 does the same).
        self.topology.assign_resindex()
        self.state.coords = np.concatenate(coords)
        self.state.velocities = None
        self.state.forces = None
        self.state.box = box.scale_vectors([nx, ny, nz])

    def save(self, path: str) -> None:
        from ..io import FileHandler

        with FileHandler(path, "w") as fh:
            fh.write(self.topology, self.state)

    def perceive(self):
        """Ring/aromaticity perception, annotating the topology in place
        (reference System::perceive / perception.rs)."""
        from ..ops.perception import perceive as _perceive

        return _perceive(self.topology)

    def apply_ff(self, ff: str = "gaff") -> list[str]:
        """GAFF/GAFF2 typing over the whole system (writes type_name)."""
        from ..ff.gaff import apply_ff as _apply

        return _apply(self, ff)

    def apply_charges(self, device=None) -> np.ndarray:
        """espaloma partial charges over the whole system (writes charge);
        the forward runs on ``device`` (None: the card)."""
        from ..ff.espaloma import apply_charges as _charges

        return _charges(self, device=device)


def _combined_coords(sel1: "Sel", sel2: Optional["Sel"]) -> np.ndarray:
    """One (N, 3) array with each selection's rows taken from ITS OWN
    viewed state (selections may be rebound to different frames —
    ``sel.state = st``). Overlapping atoms whose two states disagree are
    ambiguous in a single-array search and raise."""
    st1 = sel1.state
    if sel2 is None or sel2.state is st1:
        return st1.coords
    both = np.intersect1d(sel1.indices, sel2.indices)
    if len(both) and not np.array_equal(
        st1.coords[both], sel2.state.coords[both]
    ):
        raise SelectionError(
            "distance search between selections rebound to different "
            "states with overlapping atoms is ambiguous"
        )
    coords = st1.coords.copy()
    coords[sel2.indices] = sel2.state.coords[sel2.indices]
    return coords


def distance_search(
    cutoff,
    sel1: "Sel",
    sel2: Optional["Sel"] = None,
    pbc: PbcDims = PBC_NONE,
) -> tuple[np.ndarray, np.ndarray]:
    """Free-function pair search (reference pymolar.distance_search,
    molar_python/src/lib.rs:239-376): float cutoff or the string 'vdw'
    (per-pair vdw_i+vdw_j), one selection (self pairs) or two; returns
    ((K,2) global index pairs, (K,) distances)."""
    from ..ops import neighbor_host

    st = sel1.state
    box = st.box if pbc.any else None
    vdw = None
    if isinstance(cutoff, str):
        if cutoff != "vdw":
            raise SelectionError(f"cutoff must be a float or 'vdw', got {cutoff!r}")
        vdw = sel1.topology.vdw()
        cutoff = float(2 * vdw.max() + 1e-6)
    idx2 = None if sel2 is None else sel2.indices
    return neighbor_host.search_pairs(
        float(cutoff), _combined_coords(sel1, sel2), sel1.indices, idx2,
        box, pbc, vdw=vdw,
    )


class Sel:
    """A bound, sorted, non-empty selection over a system."""

    __slots__ = ("system", "indices", "_state")

    def __init__(self, system: System, indices: np.ndarray):
        if len(indices) == 0:
            raise SelectionError("selection is empty")
        self.system = system
        self.indices = np.asarray(indices, dtype=np.int64)
        self._state = None  # per-selection state rebind (pymolar semantics)

    # -- basics ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.indices)

    @property
    def topology(self) -> Topology:
        return self.system.topology

    @property
    def state(self) -> State:
        return self._state if self._state is not None else self.system.state

    @state.setter
    def state(self, st: State) -> None:
        # Assigning rebinds THIS selection only: the system and sibling
        # selections keep their state (the reference bindings' contract —
        # molar_python/tests/test_2.py
        # test_set_state_updates_system_time_and_returns_previous_state;
        # each Rust Sel holds its own state Arc). The per-frame trajectory
        # idiom `sel.state = st; sel.com()` works identically either way.
        if st.n_atoms != self.system.n_atoms:
            raise SelectionError(
                f"state has {st.n_atoms} atoms, system has "
                f"{self.system.n_atoms}"
            )
        self._state = st

    @property
    def coords(self) -> np.ndarray:
        """(n, 3) coordinate copy.

        Divergence note: the reference python binding returns the transposed
        (3, n) layout (selection.rs get_coords); row-per-atom is the numpy
        idiom, so this API keeps (n, 3). Transpose with ``.T`` for parity.
        """
        return self.state.coords[self.indices].copy()

    @coords.setter
    def coords(self, value: np.ndarray) -> None:
        self.state.coords[self.indices] = np.asarray(value, FLOAT).reshape(len(self), 3)

    def get_coord(self) -> np.ndarray:
        """(3, n) coordinate copy — the reference bindings' column layout
        (pymolar test.py test7); :attr:`coords` is the row-per-atom form."""
        return self.coords.T

    def set_coord(self, value: np.ndarray) -> None:
        """Set coordinates from the (3, n) column layout."""
        v = np.asarray(value, FLOAT)
        if v.shape == (3, len(self)):
            v = v.T
        self.coords = v

    @property
    def masses(self) -> np.ndarray:
        return self.topology.mass[self.indices]

    @property
    def names(self) -> np.ndarray:
        return self.topology.names(self.indices)

    @property
    def resnames(self) -> np.ndarray:
        return self.topology.resnames(self.indices)

    @property
    def resids(self) -> np.ndarray:
        return self.topology.resid[self.indices]

    @property
    def resindices(self) -> np.ndarray:
        return self.topology.resindex[self.indices]

    @property
    def time(self) -> float:
        """Time (ps) of the viewed state (pymolar parity)."""
        return self.state.time

    def __repr__(self) -> str:
        return f"Sel({len(self)} atoms)"

    # -- per-atom views --------------------------------------------------------

    def __getitem__(self, k: int) -> "Particle":
        """k-th particle of the selection (reference particle.rs:4-17)."""
        return Particle(self.system, int(self.indices[k]), owner=self)

    def __iter__(self):
        for i in self.indices:
            yield Particle(self.system, int(i), owner=self)

    # -- sub-selection / set algebra -------------------------------------------

    def select(self, seldef: SelectionDef) -> "Sel":
        """Sub-selection: evaluate within this selection as the global subset;
        plain index defs are *local* (0..len) and remapped to global
        (selection_def.rs local_to_global)."""
        if isinstance(seldef, (str, SelectionExpr)):
            idx = self.system._resolve_def(seldef, subset=self.indices)
            return Sel(self.system, idx)
        if isinstance(seldef, range):
            local = np.arange(seldef.start, seldef.stop, seldef.step, dtype=np.int64)
        elif isinstance(seldef, slice):
            local = np.arange(*seldef.indices(len(self)), dtype=np.int64)
        elif _is_range_tuple(seldef):
            # pymolar 2-tuple RANGE form, local like the other index defs
            local = np.arange(seldef[0], seldef[1], dtype=np.int64)
        else:
            local = np.unique(np.asarray(seldef, dtype=np.int64))
        if len(local) == 0:
            raise SelectionError("sub-selection is empty")
        if local.min() < 0 or local.max() >= len(self):
            raise SelectionError("sub-selection local index out of bounds")
        return Sel(self.system, self.indices[local])

    __call__ = select

    def _check_same_system(self, other: "Sel") -> None:
        if other.system is not self.system:
            raise SelectionError("set operation on selections from different systems")

    def __or__(self, other: "Sel") -> "Sel":
        self._check_same_system(other)
        return Sel(self.system, np.union1d(self.indices, other.indices))

    def __and__(self, other: "Sel") -> "Sel":
        self._check_same_system(other)
        return Sel(self.system, np.intersect1d(self.indices, other.indices))

    def __sub__(self, other: "Sel") -> "Sel":
        self._check_same_system(other)
        return Sel(self.system, np.setdiff1d(self.indices, other.indices))

    def __invert__(self) -> "Sel":
        mask = np.ones(self.system.n_atoms, dtype=bool)
        mask[self.indices] = False
        return Sel(self.system, np.nonzero(mask)[0])

    # -- splits -----------------------------------------------------------------

    def split_contig(self, key: Callable[[int], object] | np.ndarray) -> list["Sel"]:
        """Split into contiguous runs of equal key values (traits.rs:254-297)."""
        if callable(key):
            vals = np.asarray([key(i) for i in self.indices])
        else:
            vals = np.asarray(key)[self.indices]
        if len(vals) == 0:
            return []
        change = np.empty(len(vals), dtype=bool)
        change[0] = True
        change[1:] = vals[1:] != vals[:-1]
        bounds = np.nonzero(change)[0].tolist() + [len(vals)]
        return [
            Sel(self.system, self.indices[a:b]) for a, b in zip(bounds[:-1], bounds[1:])
        ]

    def split_resindex(self) -> list["Sel"]:
        return self.split_contig(self.topology.resindex)

    def split_by(self, key_fn: Callable[["Particle"], object]) -> list["Sel"]:
        """Split by an arbitrary per-particle key — the reference's
        ``split_par`` closure contract (README "Parallel splits";
        system.rs split_par): return ``None`` to drop the atom, any other
        value to group by it. Groups keep first-appearance order. The
        resulting disjoint selections are the unit of parallel work
        (segment ids / vmapped reductions on this side)."""
        groups: dict = {}
        for p in self:
            k = key_fn(p)
            if k is None:
                continue
            groups.setdefault(k, []).append(p.index)
        return [
            Sel(self.system, np.asarray(ix, dtype=np.int64))
            for ix in groups.values()
        ]

    def split_chain(self) -> list["Sel"]:
        """Group by chain value (all atoms of each chain, not just runs) —
        the Python-binding semantics (molar_python selection.rs:1396-1414)."""
        chains = self.topology.chain[self.indices]
        return [
            Sel(self.system, self.indices[chains == c]) for c in np.unique(chains)
        ]

    def split_molecule(self) -> list["Sel"]:
        """Split by TPR molecule ranges, clipped at selection borders
        (providers.rs:390-426)."""
        mols = self.topology.molecules
        out = []
        for first, last in mols:
            inside = self.indices[(self.indices >= first) & (self.indices <= last)]
            if len(inside):
                out.append(Sel(self.system, inside))
        return out

    def whole_residues(self) -> "Sel":
        """Expand to complete residues (the Python-binding semantics of
        whole_residues; selection.rs:1396-1414 — the global-id variant, not
        the reference Rust whole_attr local-index quirk, SURVEY §8.11)."""
        ri = self.topology.resindex
        present = np.unique(ri[self.indices])
        return Sel(self.system, np.nonzero(np.isin(ri, present))[0])

    def whole_chains(self) -> "Sel":
        """Expand to complete chains (global-id variant)."""
        ch = self.topology.chain
        present = np.unique(ch[self.indices])
        return Sel(self.system, np.nonzero(np.isin(ch, present))[0])

    def segment_ids(self, key: Optional[np.ndarray] = None) -> np.ndarray:
        """Contiguous-run segment id per selected atom — the device-side form
        of a split: feed to jax.ops.segment_* reductions."""
        vals = (key if key is not None else self.topology.resindex)[self.indices]
        change = np.empty(len(vals), dtype=bool)
        change[0] = False
        change[1:] = vals[1:] != vals[:-1]
        return np.cumsum(change).astype(np.int32)

    # -- measure -----------------------------------------------------------------

    def _pbc_box(self, pbc: Optional[PbcDims]):
        if pbc is None or not pbc.any:
            return None, PBC_NONE
        return self.state.require_box(), pbc

    def min_max(self) -> tuple[np.ndarray, np.ndarray]:
        from ..ops import measure_host as M

        return M.min_max(self.state.coords[self.indices])

    def com(self, pbc: Optional[PbcDims] = None) -> np.ndarray:
        from ..ops import measure_host as M

        box, dims = self._pbc_box(pbc)
        c = self.state.coords[self.indices]
        m = self.masses
        if m.sum() == 0:
            raise M.MeasureError("zero total mass")
        if box is None:
            return M.center(c, m)
        return M.center_pbc(c, m, box, dims)

    def cog(self, pbc: Optional[PbcDims] = None) -> np.ndarray:
        from ..ops import measure_host as M

        box, dims = self._pbc_box(pbc)
        c = self.state.coords[self.indices]
        if box is None:
            return M.center(c, None)
        return M.center_pbc(c, None, box, dims)

    def gyration(self, pbc: Optional[PbcDims] = None) -> float:
        from ..ops import measure_host as M

        box, dims = self._pbc_box(pbc)
        return M.gyration(self.state.coords[self.indices], self.masses, box, dims)

    def inertia(self, pbc: Optional[PbcDims] = None):
        from ..ops import measure_host as M

        box, dims = self._pbc_box(pbc)
        return M.inertia(self.state.coords[self.indices], self.masses, box, dims)

    def principal_transform(self, pbc: Optional[PbcDims] = None):
        from ..ops import measure_host as M

        box, dims = self._pbc_box(pbc)
        return M.principal_transform(
            self.state.coords[self.indices], self.masses, box, dims
        )

    def rmsd(self, other: "Sel") -> float:
        from ..ops import measure_host as M

        return M.rmsd(self.coords, other.coords)

    def rmsd_mw(self, other: "Sel") -> float:
        from ..ops import measure_host as M

        return M.rmsd_mw(self.coords, other.coords, self.masses)

    def fit_transform(self, other: "Sel"):
        """(R, t) superimposing self onto other (mass-weighted by self)."""
        from ..ops import measure_host as M

        return M.fit_transform(self.coords, other.coords, self.masses)

    def fit(self, other: "Sel") -> None:
        """Fit self's *whole system* coordinates onto other (in place)."""
        r, t = self.fit_transform(other)
        self.apply_transform(r, t)

    def fit_transform_matching(self, other: "Sel"):
        """Fit using only name-matched atoms (global sequence alignment of
        atom names; measure.rs fit_transform_matching)."""
        from ..ops import measure_host as M
        from ..ops.seq_align import matching_atoms_by_name

        mx, my = matching_atoms_by_name(self.names, other.names)
        if len(mx) == 0:
            raise SelectionError("no matching atoms between selections")
        return M.fit_transform(
            self.coords[mx], other.coords[my], self.masses[mx]
        )

    # -- property setters (Python-binding parity: set_same_* bulk writers) --------

    def set_same_resname(self, resname: str) -> None:
        code = self.topology.resname_pool.intern(resname)
        self.topology.resname[self.indices] = code

    def set_same_name(self, name: str) -> None:
        code = self.topology.name_pool.intern(name)
        self.topology.name[self.indices] = code

    def set_same_chain(self, chain: str) -> None:
        self.topology.chain[self.indices] = chain

    def set_same_mass(self, mass: float) -> None:
        self.topology.mass[self.indices] = mass

    def set_same_charge(self, charge: float) -> None:
        self.topology.charge[self.indices] = charge

    def set_same_resid(self, resid: int) -> None:
        self.topology.resid[self.indices] = int(resid)

    def set_same_bfactor(self, bfactor: float) -> None:
        self.topology.bfactor[self.indices] = bfactor

    # -- pymolar-compat aliases (molar.pyi:144-168) -------------------------------
    # The native methods take ``pbc=`` kwargs; the reference bindings expose
    # separate ``*_pbc`` entry points — thin aliases for drop-in use.

    def gyration_pbc(self) -> float:
        return self.gyration(pbc=PBC_FULL)

    def inertia_pbc(self):
        return self.inertia(pbc=PBC_FULL)

    def principal_transform_pbc(self):
        return self.principal_transform(pbc=PBC_FULL)

    def replace_state_deep(self, state: State) -> None:
        """Exchange the CONTENTS of the viewed state with ``state``
        (molar.pyi:143): every holder of the viewed State object — the
        system and sibling selections included, when this selection views
        the system state — observes the new values in place."""
        if state.n_atoms != self.system.n_atoms:
            raise SelectionError(
                f"state has {state.n_atoms} atoms, system has "
                f"{self.system.n_atoms}"
            )
        cur = self.state
        for f in ("coords", "velocities", "forces", "time", "box", "step"):
            a, b = getattr(cur, f), getattr(state, f)
            setattr(cur, f, b)
            setattr(state, f, a)

    def set_box_from(self, src) -> None:
        """Copy the box of ``src`` (System or Sel) into the viewed state
        (molar.pyi:150). A fresh PeriodicBox, never an alias — the same
        no-alias invariant as System.set_box_from."""
        b = src.state.box
        self.state.box = None if b is None else PeriodicBox(b.matrix.copy())

    def iter_pos(self):
        """Yield each selected atom's position row (molar.pyi:167)."""
        for i in self.indices:
            yield self.state.coords[i]

    def iter_atoms(self):
        """Yield each selected atom as an :class:`Atom` (molar.pyi:168)."""
        for i in self.indices:
            yield self.topology.atom(int(i))

    # -- modify ------------------------------------------------------------------

    def translate(self, shift) -> None:
        self.state.coords[self.indices] += np.asarray(shift, FLOAT)

    def apply_transform(self, r: np.ndarray, t: np.ndarray) -> None:
        c = self.state.coords[self.indices].astype(np.float64)
        self.state.coords[self.indices] = (c @ np.asarray(r).T + np.asarray(t)).astype(
            FLOAT
        )

    def rotate(self, axis, angle: float, pivot: Optional[np.ndarray] = None) -> None:
        """Rotate about an axis through ``pivot`` (default: COG) by ``angle``
        radians (modify.rs:15-40)."""
        axis = np.asarray(axis, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        if pivot is None:
            pivot = self.cog()
        k = axis
        kx = np.array(
            [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
        )
        r = np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * (kx @ kx)
        t = pivot - r @ pivot
        self.apply_transform(r, t)

    def unwrap_simple(self, pbc: PbcDims = PBC_FULL) -> None:
        """Move every atom to its closest image relative to the selection's
        first atom (modify.rs unwrap_simple)."""
        box = self.state.require_box()
        c = self.state.coords[self.indices]
        ref = c[0]
        self.state.coords[self.indices] = ref + box.shortest_vector(c - ref, pbc)

    def wrap(self) -> None:
        """Wrap selected atoms into the primary cell (conventional wrap)."""
        box = self.state.require_box()
        self.state.coords[self.indices] = box.wrap_conventional(
            self.state.coords[self.indices]
        )

    def unwrap_connectivity(
        self, cutoff: float = 0.2, pbc: PbcDims = PBC_FULL
    ) -> list["Sel"]:
        """Unwrap via BFS flood fill over distance-search connectivity within
        ``cutoff``: each newly-reached atom moves to the closest image of the
        atom it was discovered from; every connected piece is returned as a
        Sel (modify.rs unwrap_connectivity + connectivity.rs)."""
        from collections import deque

        from ..ops import neighbor_host

        box = self.state.require_box()
        n = len(self)
        local = np.arange(n)
        pairs, _ = neighbor_host.search_pairs(
            cutoff, self.state.coords[self.indices], local, None, box, pbc
        )
        adj: list[list[int]] = [[] for _ in range(n)]
        for a, b in pairs:
            adj[a].append(b)
            adj[b].append(a)
        coords = self.state.coords[self.indices].copy()
        used = np.zeros(n, dtype=bool)
        pieces: list[Sel] = []
        for start in range(n):
            if used[start]:
                continue
            used[start] = True
            piece = [start]
            todo = deque([start])
            while todo:
                c = todo.popleft()
                p0 = coords[c]
                for nb in adj[c]:
                    if not used[nb]:
                        used[nb] = True
                        coords[nb] = p0 + box.shortest_vector(coords[nb] - p0, pbc)
                        piece.append(nb)
                        todo.append(nb)
            pieces.append(Sel(self.system, self.indices[np.sort(piece)]))
        self.state.coords[self.indices] = coords
        return pieces

    # -- sasa ------------------------------------------------------------------------

    def sasa(self, probe: float = 0.14, with_volume: bool = False, n_slices: int = 64):
        """Solvent-accessible surface areas (exact Lee-Richards host path;
        reference: sasa.rs / Measure::sasa). Returns a Sasa result object."""
        from ..ops.sasa_host import Sasa as _Sasa

        return _Sasa(
            self.state.coords[self.indices],
            self.topology.vdw()[self.indices],
            probe=probe,
            with_volume=with_volume,
            n_slices=n_slices,
        )

    def sas_mesh(self, probe: float = 0.14, spacing: float = 0.05):
        """Solvent-accessible surface triangle mesh (verts, tris); the
        reference exposes SAS meshes from powersasa (sasa.rs:14-122)."""
        from ..ops.surface import sas_mesh as _sas_mesh

        return _sas_mesh(self.state.coords[self.indices], self.topology.vdw()[self.indices],
                         probe=probe, spacing=spacing)

    def ses_mesh(self, probe: float = 0.14, spacing: float = 0.05):
        """Solvent-excluded (molecular) surface triangle mesh (verts, tris)."""
        from ..ops.surface import ses_mesh as _ses_mesh

        return _ses_mesh(self.state.coords[self.indices], self.topology.vdw()[self.indices],
                         probe=probe, spacing=spacing)

    # -- secondary structure -------------------------------------------------------

    def dssp(self, flavor: str = "gmx") -> str:
        """Per-residue DSSP string (flavor 'gmx' reproduces `gmx dssp`,
        'vanilla' canonical Kabsch-Sander; measure.rs ss entry points)."""
        from ..ops.dssp import compute_dssp

        return compute_dssp(self, flavor=flavor).ss_string()

    def dss(self) -> str:
        """Per-residue PyMOL-style 3-state string (H/E/~)."""
        from ..ops.dss import compute_dss

        return compute_dss(self).ss_string()

    def ss_compute(self, algorithm: str = "dssp") -> str:
        """Unified SS entry point: 'dssp' | 'dssp_gmx' | 'dss'."""
        if algorithm == "dssp":
            return self.dssp("vanilla")
        if algorithm == "dssp_gmx":
            return self.dssp("gmx")
        if algorithm == "dss":
            return self.dss()
        raise ValueError(f"unknown ss algorithm {algorithm!r}")

    # -- distance search ----------------------------------------------------------

    def within_of(self, cutoff: float, other: "Sel", pbc: PbcDims = PBC_NONE) -> "Sel":
        """Atoms of self within cutoff of other (self-inclusive at d=0).

        Each selection's rows come from its own viewed state (selections
        can be rebound per frame)."""
        from ..ops import neighbor_host

        box = self.state.box if pbc.any else None
        found = neighbor_host.search_within(
            cutoff, _combined_coords(self, other), self.indices,
            other.indices, box, pbc,
        )
        return Sel(self.system, found)

    # -- io -------------------------------------------------------------------------

    def save(self, path: str) -> None:
        from ..io import FileHandler

        with FileHandler(path, "w") as fh:
            fh.write(self.topology, self.state, indices=self.indices)

    def set_state(self, state: State) -> State:
        """Rebind this selection to a new state (same atom count),
        returning the previously-viewed one — the per-frame loop of the
        reference python bindings (``sel.state = st``; the system and other
        selections are unaffected, see the ``state`` property)."""
        old = self.state
        self.state = state
        return old

    def __rshift__(self, system: "System") -> "Sel":
        """``sel >> other_system``: rebind this selection's indices to another
        system (the reference's Shr operator sugar, system.rs:422-435)."""
        return system.bind(self)

    def to_system(self) -> "System":
        """Detached copy of the selected atoms as a standalone System."""
        st = self.state
        new_state = State(
            coords=st.coords[self.indices].copy(),
            velocities=(
                st.velocities[self.indices].copy()
                if st.velocities is not None
                else None
            ),
            forces=st.forces[self.indices].copy() if st.forces is not None else None,
            time=st.time,
            box=None if st.box is None else PeriodicBox(st.box.matrix.copy()),
            step=st.step,
        )
        return System(self.topology.subset(self.indices), new_state)

    def to_gromacs_ndx(self, name: str) -> str:
        """Gromacs ndx group text (1-based; providers.rs as_gromacs_ndx_str)."""
        lines = [f"[ {name} ]"]
        vals = self.indices + 1
        for i in range(0, len(vals), 15):
            lines.append(" ".join(str(v) for v in vals[i : i + 15]))
        return "\n".join(lines) + "\n"


class Particle:
    """Mutable single-atom view: global index + property accessors backed by
    the SoA columns (reference particle.rs:4-17 — {id, atom, pos}).

    Reads decode from the interned columns; writes intern/scatter back, so a
    Particle is a convenience handle, not a hot-loop API (bulk work goes
    through the column arrays / device kernels).
    """

    __slots__ = ("system", "index", "_owner")

    def __init__(self, system: System, index: int, owner: "Sel | None" = None):
        self.system = system
        self.index = int(index)
        # Particles obtained through a selection read/write that
        # selection's (possibly rebound) state view — the live lookup
        # keeps them consistent after `sel.state = st` (pymolar contract).
        self._owner = owner

    @property
    def _st(self) -> State:
        return self._owner.state if self._owner is not None else self.system.state

    # identity -------------------------------------------------------------
    @property
    def id(self) -> int:
        return self.index

    @property
    def atom(self) -> "Atom":
        """Detached Atom copy of this row."""
        return self.system.topology.atom(self.index)

    # position --------------------------------------------------------------
    @property
    def pos(self) -> np.ndarray:
        return self._st.coords[self.index]

    @pos.setter
    def pos(self, value) -> None:
        self._st.coords[self.index] = np.asarray(value, FLOAT)

    def _coord(axis):  # noqa: N805 - tiny descriptor factory
        def get(self):
            return float(self._st.coords[self.index, axis])

        def set(self, value):
            self._st.coords[self.index, axis] = value

        return property(get, set)

    x = _coord(0)
    y = _coord(1)
    z = _coord(2)
    del _coord

    # atom properties ---------------------------------------------------------
    @property
    def name(self) -> str:
        t = self.system.topology
        return t.name_pool.lookup(int(t.name[self.index]))

    @name.setter
    def name(self, value: str) -> None:
        t = self.system.topology
        t.name[self.index] = t.name_pool.intern(value)

    @property
    def resname(self) -> str:
        t = self.system.topology
        return t.resname_pool.lookup(int(t.resname[self.index]))

    @resname.setter
    def resname(self, value: str) -> None:
        t = self.system.topology
        t.resname[self.index] = t.resname_pool.intern(value)

    def _col(name):  # noqa: N805 - tiny descriptor factory
        def get(self):
            v = getattr(self.system.topology, name)[self.index]
            return v.item() if hasattr(v, "item") else v

        def set(self, value):
            getattr(self.system.topology, name)[self.index] = value

        return property(get, set)

    resid = _col("resid")
    resindex = _col("resindex")
    atomic_number = _col("atomic_number")
    mass = _col("mass")
    charge = _col("charge")
    chain = _col("chain")
    bfactor = _col("bfactor")
    occupancy = _col("occupancy")
    del _col

    def __repr__(self) -> str:
        return f"Particle({self.index}: {self.name} {self.resname}{self.resid})"
