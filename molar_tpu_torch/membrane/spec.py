"""The static structure of a membrane analysis, as plain numpy arrays.

``molar_tpu.membrane.device.MembraneDevice.__init__`` derives these arrays
from a ``Membrane`` (its lipids, their selections and species).
:class:`MembraneSpec` holds the arrays themselves and is built three ways:
:meth:`MembraneSpec.from_membrane` from the port's own host ``Membrane``,
:meth:`MembraneSpec.from_toml` from a user's membrane TOML on a
:class:`~molar_tpu_torch.core.system.System` (through that ``Membrane``),
and :meth:`MembraneSpec.from_templates` from offset templates: for each
species the head, mid and tail atom offsets within a lipid and the tail
bond orders, for each lipid its species, first row and atom count. Every
index below is local to ``subset``, the global rows a window ships, lipid
by lipid.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .membrane import Membrane
from .stats import MembraneError, MembraneOptions


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
        box): that of ``Membrane(system, text)``, with its errors."""
        return MembraneSpec.from_membrane(Membrane(system, text))

    @staticmethod
    def from_membrane(membrane) -> "MembraneSpec":
        """The spec of a host :class:`~molar_tpu_torch.membrane.membrane.Membrane`:
        its lipids in its order, its species' offsets, its build frame's box
        and its groups' lipid ids now (``MembraneDevice(membrane)`` folds
        into the membrane's own groups, whatever their ids later)."""
        lipids = [(lip.species.name, np.asarray(lip.sel.indices, np.int64))
                  for lip in membrane.lipids]
        species = {sp.name: (sp.head_offsets, sp.mid_offsets, sp.tails, sp.tail_end_offsets)
                   for sp in membrane.species}
        groups = {name: list(gr.lipid_ids) for name, gr in membrane.groups.items()}
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
        mat = np.asarray(membrane.system.state.require_box().matrix, np.float64)
        return MembraneSpec(
            subset=subset,
            first=first,
            atom_first=atom_first,
            masses=np.asarray(membrane.system.topology.mass, np.float32)[subset],
            head=marker(0),
            mid=marker(1),
            tail=marker(3),
            species_names=species_names,
            sp_lipids=sp_lipids,
            sp_tails=sp_tails,
            species_of=np.asarray([species_names.index(sp) for sp, _ in lipids], np.int32),
            triclinic=bool(np.abs(mat - np.diag(np.diag(mat))).max() > 1e-9),
            options=membrane.options,
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
