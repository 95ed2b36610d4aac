"""The static structure of a membrane analysis, as plain numpy arrays.

``molar_tpu.membrane.device.MembraneDevice.__init__`` derives these arrays
from a ``Membrane`` (its lipids, their selections and species).
:class:`MembraneSpec` holds the arrays themselves and is built two ways:
:meth:`MembraneSpec.from_toml` from a user's membrane TOML on a
:class:`~molar_tpu_torch.core.system.System`, as ``Membrane.__init__`` and
``LipidSpecies`` derive it (the species' selection strings evaluated by the
host selection language), and :meth:`MembraneSpec.from_templates` from
offset templates: for each species the head, mid and tail atom offsets
within a lipid and the tail bond orders, for each lipid its species, first
row and atom count. Every index below is local to ``subset``, the global
rows a window ships, lipid by lipid. :func:`leaflets` splits the lipids
by the build frame's head markers, as the JAX package's ``membrane``
command does for groups ``upper`` and ``lower``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..selection import SelectionEvalError, SelectionExpr, SelectionSyntaxError
from .stats import MembraneError, MembraneOptions

# What makes a species' ``whole`` selection skip the species, as
# ``Membrane.__init__``'s ``try: ... except: continue`` does: a missing
# key, text the parser refuses or the evaluator cannot run.
_SKIPPED = (KeyError, TypeError, SelectionSyntaxError, SelectionEvalError)


@dataclass(frozen=True)
class SpeciesTemplate:
    """Atom offsets of one lipid species from its first atom: ``head`` and
    ``mid`` marker atoms, and ``tails``, one ``(carbon offsets, bond
    orders)`` pair a tail (``len(orders) == len(offsets) - 1``; 1 for
    ``-``, 2 for ``=`` in the reference's tail strings)."""

    head: tuple
    mid: tuple
    tails: tuple = ()

    @property
    def tail_end(self) -> tuple:
        """The last carbon of each tail, or offset 0 without a tail."""
        return tuple(int(offsets[-1]) for offsets, _ in self.tails) or (0,)


@dataclass
class MembraneSpec:
    """``subset`` (n,) global rows; ``first`` (L,) each lipid's first row
    and ``atom_first`` (n,) that of each row's lipid; ``masses`` (n,) f32;
    ``head`` / ``mid`` / ``tail`` ``(idx, seg)``: the marker rows and their
    lipid ids; ``species_names`` sorted; ``sp_lipids[sp]`` the lipid ids of
    a species; ``sp_tails[sp]`` one ``(rows (n_sp, n_carbons), bond
    orders)`` a tail; ``species_of`` (L,) index into ``species_names``;
    ``triclinic`` the kind of the build box; ``groups`` name -> lipid ids."""

    subset: np.ndarray
    first: np.ndarray
    atom_first: np.ndarray
    masses: np.ndarray
    head: tuple
    mid: tuple
    tail: tuple
    species_names: list
    sp_lipids: dict
    sp_tails: dict
    species_of: np.ndarray
    triclinic: bool
    options: MembraneOptions
    groups: dict = field(default_factory=dict)

    @property
    def n_lipids(self) -> int:
        return len(self.first)

    @staticmethod
    def from_toml(system, text) -> "MembraneSpec":
        """The spec of a membrane TOML (or :class:`MembraneOptions`) on
        ``system`` (a :class:`~molar_tpu_torch.core.system.System` with a
        box), as ``Membrane(system, text)`` and ``MembraneDevice`` build it:
        ``sel`` evaluated on the system; each species of ``lipids``, in the
        TOML's order, its ``whole`` evaluated within ``sel`` (a species
        whose selection fails or matches nothing is skipped) and split into
        lipids by contiguous runs of residue index; the head, mid and tail
        atom offsets taken from the species' first lipid. Named groups
        start empty; without ``groups`` the one group ``"all"`` holds every
        lipid. Raises :class:`MembraneError` as the reference does."""
        options = MembraneOptions.from_toml(text) if isinstance(text, str) else text
        top, state = system.topology, system.state
        box = state.require_box()

        def select(sel_text, subset):
            idx = SelectionExpr(sel_text).apply(top, state, subset)
            if len(idx) == 0:
                raise MembraneError(f"selection is empty: {sel_text!r}")
            return np.asarray(idx, np.int64)

        src = select(options.sel, None)
        lipids = []  # (species name, global atom indices)
        species = {}  # name -> (head offsets, mid offsets, tails, tail-end offsets)
        for name, descr in options.lipids.items():
            try:
                whole = SelectionExpr(descr["whole"]).apply(top, state, src)
            except _SKIPPED:
                continue
            if len(whole) == 0:
                continue
            runs = _split_contig(np.asarray(whole, np.int64), top.resindex)
            species[name] = _species(name, descr, runs[0], select)
            lipids += [(name, r) for r in runs]
        if not lipids:
            raise MembraneError("no lipids matched the configured species")

        subset = np.concatenate([r for _, r in lipids])
        g2l = {int(g): i for i, g in enumerate(subset)}

        def loc(garr):
            return np.asarray([g2l[int(g)] for g in garr], np.int32)

        first = loc([r[0] for _, r in lipids])
        atom_first = np.concatenate([np.full(len(r), first[i], np.int32)
                                     for i, (_, r) in enumerate(lipids)])

        def marker(k):
            idx = [loc(r[0] + species[sp][k]) for sp, r in lipids]
            seg = [np.full(len(a), i, np.int32) for i, a in enumerate(idx)]
            return np.concatenate(idx).astype(np.int32), np.concatenate(seg)

        species_names = sorted({sp for sp, _ in lipids})
        sp_lipids, sp_tails = {}, {}
        for sp in species_names:
            lids = np.asarray([i for i, (s, _) in enumerate(lipids) if s == sp], np.int32)
            sp_lipids[sp] = lids
            sp_tails[sp] = [
                ((first[lids][:, None] + np.asarray(offs, np.int32)).astype(np.int32),
                 tuple(int(o) for o in orders))
                for offs, orders in species[sp][2]
            ]
        groups = {name: [] for name in (options.groups or ["all"])}
        if "all" in groups and not options.groups:
            groups["all"] = list(range(len(lipids)))
        mat = np.asarray(box.matrix, np.float64)
        return MembraneSpec(
            subset=subset,
            first=first,
            atom_first=atom_first,
            masses=np.asarray(top.mass, np.float32)[subset],
            head=marker(0),
            mid=marker(1),
            tail=marker(3),
            species_names=species_names,
            sp_lipids=sp_lipids,
            sp_tails=sp_tails,
            species_of=np.asarray([species_names.index(sp) for sp, _ in lipids], np.int32),
            triclinic=bool(np.abs(mat - np.diag(np.diag(mat))).max() > 1e-9),
            options=options,
            groups=groups,
        )

    @staticmethod
    def from_templates(templates: dict, lipids, masses, box_matrix, options: MembraneOptions,
                       groups=None) -> "MembraneSpec":
        """``templates`` species name -> :class:`SpeciesTemplate`;
        ``lipids`` ``(species name, first row, atom count)`` in the order
        the reference's ``Membrane`` enumerates them (species in the
        options' order, then residue order), each lipid's atoms contiguous;
        ``masses`` every atom's mass; ``box_matrix`` the build box.
        ``groups`` name -> lipid ids; None gives every group the options
        name (or "all") its lipids: all of them for "all", none else."""
        if not lipids:
            raise MembraneError("no lipids matched the configured species")
        masses = np.asarray(masses, np.float32)
        subset, first, atom_first = [], [], []
        n_local = 0
        for lid, (sp, row0, count) in enumerate(lipids):
            t = templates[sp]
            offsets = [*t.head, *t.mid, *t.tail_end,
                       *(o for offs, _ in t.tails for o in offs)]
            if not t.head or not t.mid or max(offsets) >= count or min(offsets) < 0:
                raise MembraneError(f"species {sp!r}: marker offsets {offsets} do not fit a "
                                    f"lipid of {count} atoms")
            subset.append(np.arange(row0, row0 + count))
            first.append(n_local)
            atom_first.append(np.full(count, n_local, np.int32))
            n_local += count
        first = np.asarray(first, np.int32)

        def marker(offsets_of):
            idx = [first[i] + np.asarray(offsets_of(templates[sp]), np.int32)
                   for i, (sp, _, _) in enumerate(lipids)]
            seg = [np.full(len(a), i, np.int32) for i, a in enumerate(idx)]
            return np.concatenate(idx).astype(np.int32), np.concatenate(seg)

        species_names = sorted({sp for sp, _, _ in lipids})
        sp_lipids, sp_tails = {}, {}
        for sp in species_names:
            lids = np.asarray([i for i, (s, _, _) in enumerate(lipids) if s == sp], np.int32)
            sp_lipids[sp] = lids
            sp_tails[sp] = [
                ((first[lids][:, None] + np.asarray(offs, np.int32)).astype(np.int32),
                 tuple(int(o) for o in orders))
                for offs, orders in templates[sp].tails
            ]
        if groups is None:
            groups = {name: list(range(len(lipids))) if name == "all" else []
                      for name in (options.groups or ["all"])}
        mat = np.asarray(box_matrix, np.float64)
        subset = np.concatenate(subset)
        return MembraneSpec(
            subset=subset,
            first=first,
            atom_first=np.concatenate(atom_first),
            masses=masses[subset],
            head=marker(lambda t: t.head),
            mid=marker(lambda t: t.mid),
            tail=marker(lambda t: t.tail_end),
            species_names=species_names,
            sp_lipids=sp_lipids,
            sp_tails=sp_tails,
            species_of=np.asarray([species_names.index(sp) for sp, _, _ in lipids], np.int32),
            triclinic=bool(np.abs(mat - np.diag(np.diag(mat))).max() > 1e-9),
            options=options,
            groups={name: [int(i) for i in ids] for name, ids in groups.items()},
        )


def _split_contig(idx: np.ndarray, key: np.ndarray) -> list:
    """``idx`` split into contiguous runs of equal ``key[idx]``
    (``Sel.split_contig``)."""
    vals = np.asarray(key)[idx]
    change = np.empty(len(vals), dtype=bool)
    change[0] = True
    change[1:] = vals[1:] != vals[:-1]
    bounds = np.nonzero(change)[0].tolist() + [len(vals)]
    return [idx[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _parse_tail(text: str) -> tuple[list, list]:
    """A tail string ``"C1-C2=C3"`` -> (carbon names, bond orders: 1 for
    ``-``, 2 for ``=``), with ``LipidSpecies``' two errors."""
    names, orders = [], []
    cur = text
    while True:
        cut = min([i for i in (cur.find("-"), cur.find("=")) if i >= 0], default=-1)
        if cut < 0:
            break
        if cut == 0:
            raise MembraneError(f"missing carbon atom name in tail {text!r}")
        names.append(cur[:cut])
        orders.append(1 if cur[cut] == "-" else 2)
        cur = cur[cut + 1:]
    if not cur:
        raise MembraneError(f"missing last carbon atom name in tail {text!r}")
    names.append(cur)
    return names, orders


def _species(name: str, descr: dict, first_lipid: np.ndarray, select) -> tuple:
    """``LipidSpecies``' offsets from the species' first lipid (global
    indices): (head offsets, mid offsets, tails as (offsets, orders),
    tail-end offsets: the last carbon of each tail, or 0 without one)."""
    first_index = int(first_lipid[0])
    head = select(descr["head"], first_lipid) - first_index
    mid = select(descr["mid"], first_lipid) - first_index
    tails = []
    for t in descr.get("tails", []):
        names, orders = _parse_tail(t)
        offsets = []
        for nm in names:
            a = select(f"name {nm}", first_lipid)
            if len(a) != 1:
                raise MembraneError(f"tail atom {nm} not unique in lipid")
            offsets.append(int(a[0]) - first_index)
        tails.append((np.asarray(offsets, np.int64), np.asarray(orders, np.int64)))
    tail_end = np.asarray([t[0][-1] for t in tails] or [0], np.int64)
    return head, mid, tails, tail_end


def leaflets(spec: MembraneSpec, coords, box) -> tuple[list, list]:
    """The lipids of ``spec`` split into leaflets on a build frame, as the
    JAX package's ``membrane`` command does for groups ``upper`` and
    ``lower``: each lipid unwrapped round its first atom, its head marker
    the mass-weighted centre of its head atoms, and the lipids whose
    marker's z lies above the median of them all in the upper leaflet, the
    rest in the lower. ``coords`` (n_atoms, 3) global rows; ``box`` a
    :class:`~molar_tpu_torch.core.pbc.PeriodicBox`. -> (upper ids, lower
    ids)."""
    sub = np.asarray(coords, np.float32)[spec.subset]
    ref = sub[spec.atom_first]
    u = (ref + box.shortest_vector(sub - ref)).astype(np.float32)
    idx, seg = spec.head
    z = np.empty(spec.n_lipids)
    for lid in range(spec.n_lipids):
        rows = idx[seg == lid]
        w = spec.masses[rows].astype(np.float64)
        # measure_host.center's sum, in its order
        z[lid] = ((w[:, None] * u[rows].astype(np.float64)).sum(axis=0) / w.sum())[2]
    z0 = float(np.median(z))
    ids = np.arange(spec.n_lipids)
    return [int(i) for i in ids[z > z0]], [int(i) for i in ids[z <= z0]]
