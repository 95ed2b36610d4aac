"""Carry the analysis inputs across from numpy to torch.

The system has no weights: its "parameters" are the reference coordinates,
masses, the selections, the box, the cutoff and the static grid sizes. Tests
build the JAX side and the torch side from the same numpy arrays through
this module, and the window pipeline moves every window through
:func:`transport_to_torch`.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import FLOAT
from .core.pbc import PeriodicBox


def transport_to_torch(window, device, non_blocking: bool = False, alloc=None):
    """One ``TrajectoryReader.iter_windows`` item -> ``(transport, boxes,
    invs)`` on ``device``.

    ``transport`` keeps the wire form: a f32 ``(B, N, 3)`` tensor, the pair
    ``(i16 ints, scale)``, or the triple ``(frame0 i16, deltas i8, scale)``
    (scale a 0-d f32 tensor); :func:`tasks.trajectory.decode_window_coords`
    expands all three bit-exactly. A ``non_blocking`` copy returns before
    the bytes have left the host, so its source must be pinned memory that
    stays untouched until the copy has completed: the window's arrays as
    ``iter_windows(..., alloc=...)`` placed them in a staging buffer, the
    small ones (boxes, scale) placed there by ``alloc`` here.
    """
    coords, boxes, invs = window[0], window[1], window[2]

    def conv(a):
        if isinstance(a, np.generic) or np.ndim(a) == 0:
            a = np.asarray(a, dtype=np.float32)
        a = np.ascontiguousarray(a)
        if alloc is not None and not alloc.owns(a):
            staged = alloc(a.shape, a.dtype)
            staged[...] = a
            a = staged
        return torch.from_numpy(a).to(device, non_blocking=non_blocking)

    transport = tuple(map(conv, coords)) if isinstance(coords, tuple) else conv(coords)
    return transport, conv(boxes), conv(invs)


def topology_from_numpy(names, resnames, resid, resindex, chain, mass, charge, occupancy,
                        bfactor, atomic_number, bonds=None, bond_orders=None,
                        formal_charge=None, type_names=None, molecules=None):
    """A :class:`~molar_tpu_torch.core.topology.Topology` from plain
    per-atom arrays: ``names``/``resnames`` strings (at most 8 characters),
    ``chain`` one-character strings, the numeric columns, ``bonds`` ``(K,
    2)`` atom index pairs (or None) with their ``bond_orders`` (K,), and
    the optional columns ``formal_charge``, ``type_names`` (strings) and
    ``molecules`` (inclusive ``[first, last]`` atom ranges). Tests pass the
    JAX package's topology through its columns."""
    from .core.topology import Topology

    n = len(names)
    top = Topology(n)
    top.name = top.name_pool.intern_all([str(s) for s in names])
    top.resname = top.resname_pool.intern_all([str(s) for s in resnames])
    top.resid = np.asarray(resid, np.int64).copy()
    top.resindex = np.asarray(resindex, np.int32).copy()
    top.chain = np.asarray(chain, dtype="U1").copy()
    top.mass = np.asarray(mass, np.float32).copy()
    top.charge = np.asarray(charge, np.float32).copy()
    top.occupancy = np.asarray(occupancy, np.float32).copy()
    top.bfactor = np.asarray(bfactor, np.float32).copy()
    top.atomic_number = np.asarray(atomic_number, np.int16).copy()
    if bonds is not None:
        top.set_bonds(bonds, bond_orders)
    elif bond_orders is not None:
        raise ValueError("bond_orders given without bonds")
    if formal_charge is not None:
        top.formal_charge = np.asarray(formal_charge, np.int8).copy()
    if type_names is not None:
        top.type_pool.intern("")
        top.type_name = top.type_pool.intern_all([str(s) for s in type_names])
    if molecules is not None:
        top.molecules = np.asarray(molecules, np.int32).reshape(-1, 2).copy()
    top.check_sizes()
    return top


def from_numpy(ref_coords, masses, protein_idx, box_matrix, cutoff, caps, dims, device,
               search: str = "ghost"):
    """Build the headline :class:`~molar_tpu_torch.headline.FitWithinWindow`
    on ``device`` from numpy inputs. ``caps`` is ``(cap, tgt_cap,
    max_tgt_cells)``. The route is picked here, on the host, from the numpy
    box and the grid: an orthorhombic box takes the ghost-slab kernels with
    ``search="ghost"`` and the row kernel with ``search="rows"``. A skewed
    box keeps ``"ghost"`` where every cell of ``dims`` is at least a cutoff
    thick between opposite faces (``dims`` no finer than
    :func:`~molar_tpu_torch.ops.neighbor.grid_dims_for` on every axis; the
    window is fully periodic): every periodic image within the cutoff is
    then a +-1-cell lattice shift, which the ghost stencil visits. Any
    other skewed box, and ``search="rows"`` (whose per-axis image is
    orthorhombic only) on one, takes the triclinic correction path, which
    ``search="corrections"`` asks for on any box."""
    from .headline import SEARCHES, FitWithinWindow
    from .ops.neighbor import grid_dims_for

    if search not in SEARCHES:
        raise ValueError(f"search must be one of {SEARCHES}, got {search!r}")
    box = PeriodicBox(box_matrix)
    skewed = box.is_triclinic
    if skewed and not (search == "ghost"
                       and all(d <= g for d, g in zip(dims, grid_dims_for(box, cutoff)))):
        search = "corrections"
    cap, tgt_cap, max_tgt_cells = caps
    return FitWithinWindow(
        ref=torch.as_tensor(np.asarray(ref_coords, np.float32), dtype=FLOAT),
        masses=torch.as_tensor(np.asarray(masses, np.float32), dtype=FLOAT),
        protein_idx=torch.as_tensor(np.asarray(protein_idx, np.int64)),
        cutoff=float(cutoff),
        dims=tuple(int(d) for d in dims),
        cap=int(cap),
        tgt_cap=int(tgt_cap),
        search=search,
        max_tgt_cells=int(max_tgt_cells),
        skewed=skewed,
    ).to(device)


def workload_from_numpy(name: str, system, device):
    """Build the selection workload ``name`` (one of
    ``molar_tpu_torch.workloads.WORKLOADS`` but ``membrane``) on ``device`` from a
    :class:`~molar_tpu_torch.workloads.System` of numpy arrays -> (module,
    subset): the module's buffers index the rows of ``subset``, the sorted
    atom indices its windows ship."""
    from . import workloads as wl
    from .ops.measure import contiguous_segments_dense
    from .ops.neighbor import estimate_caps, grid_dims, grid_dims_for
    from .ops.sasa_lr import neighbor_lists

    if name not in wl.WORKLOADS or name == "membrane":
        raise ValueError(f"workload must be one of {tuple(wl.WORKLOADS)} but membrane (a "
                         f"MembraneDevice of a Bilayer), got {name!r}")

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=FLOAT)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64))

    subset = {
        "ca_rmsd": system.ca,
        "com_splits": system.protein,
        "contacts": np.concatenate([system.protein, system.ligand]),
        "fused": np.unique(np.concatenate([system.ca, system.protein, system.ligand])),
        "sasa": system.protein,
    }[name]

    def rows(atoms):
        return np.searchsorted(subset, atoms)

    def ca_rmsd():
        return wl.CaRmsd(f32(system.coords[system.ca]), f32(system.masses[system.ca]))

    def com_splits():
        idx, w, _ = contiguous_segments_dense(system.segment_ids, system.masses[system.protein])
        return wl.ComSplits(i64(rows(system.protein)[idx]), f32(w))

    def contacts():
        # In "contacts" the ligand rows follow the protein rows, whatever
        # their atom indices; in "fused" the union is sorted.
        if name == "contacts":
            n = len(system.protein)
            src, tgt = np.arange(n), n + np.arange(len(system.ligand))
        else:
            src, tgt = rows(system.protein), rows(system.ligand)
        return wl.Contacts(i64(src), i64(tgt), grid_dims_for(PeriodicBox(system.box), wl.CUTOFF),
                           wl.CUTOFF, wl.MAX_PAIRS, wl.GRID_CAP)

    def sasa():
        # Frame-0 exact counts size the static caps; overflow escalates tiers.
        radii = wl.sasa_radii(len(system.protein))
        extents = PeriodicBox(system.box).box_extents().astype(np.float64)
        dims = grid_dims(extents, 2 * float(radii.max()))
        c0 = system.coords[system.protein].astype(np.float64)
        nb0, _ = neighbor_lists(c0, radii, cap=1024)
        cell0, _, _ = estimate_caps(c0, np.diag(1.0 / extents), dims, margin=1.0, round_to=1)
        idx, w, _ = contiguous_segments_dense(system.segment_ids)
        return wl.Sasa(f32(radii), i64(idx), f32(w), extents, dims,
                       int((nb0 >= 0).sum(1).max()), int(cell0))

    if name == "fused":
        model = wl.Fused(i64(rows(system.ca)), ca_rmsd(), com_splits(), contacts())
    else:
        model = {"ca_rmsd": ca_rmsd, "com_splits": com_splits, "contacts": contacts,
                 "sasa": sasa}[name]()
    return model.to(device), subset


def membrane_from_reference(dev):
    """The static structure of a reference ``MembraneDevice`` (JAX package)
    as a :class:`~molar_tpu_torch.membrane.spec.MembraneSpec`, and its
    ``patch_cap`` -> (spec, patch_cap). Read by attribute, without an
    import of the reference, so that tests can build both packages on one
    problem: ``subset``, ``_first``, ``_atom_first``, ``_masses``, the
    ``_head`` / ``_mid`` / ``_tail`` pairs, ``species_names``,
    ``_sp_lipids``, ``_sp_tails``, ``species_of``, ``_triclinic``,
    ``options`` and the group memberships of its ``membrane``."""
    import dataclasses

    from .membrane.spec import MembraneSpec
    from .membrane.stats import MembraneOptions

    names = [f.name for f in dataclasses.fields(MembraneOptions)]
    options = MembraneOptions(**{k: getattr(dev.options, k) for k in names})

    def pair(p):
        return tuple(np.asarray(a, np.int32) for a in p)

    spec = MembraneSpec(
        subset=np.asarray(dev.subset),
        first=np.asarray(dev._first, np.int32),
        atom_first=np.asarray(dev._atom_first, np.int32),
        masses=np.asarray(dev._masses, np.float32),
        head=pair(dev._head),
        mid=pair(dev._mid),
        tail=pair(dev._tail),
        species_names=list(dev.species_names),
        sp_lipids={sp: np.asarray(a, np.int32) for sp, a in dev._sp_lipids.items()},
        sp_tails={sp: [(np.asarray(tl, np.int32), tuple(int(o) for o in orders))
                       for tl, orders in tails] for sp, tails in dev._sp_tails.items()},
        species_of=np.asarray(dev.species_of, np.int32),
        triclinic=bool(dev._triclinic),
        options=options,
        groups={name: [int(i) for i in gr.lipid_ids]
                for name, gr in dev.membrane.groups.items()},
    )
    return spec, int(dev.patch_cap)


def espaloma_from_numpy(initializers: dict, device):
    """An :class:`~molar_tpu_torch.ff.espaloma.EspalomaGNN` on ``device``
    whose buffers are ``initializers`` (name -> numpy array, e.g. the JAX
    package's ``_graph().initializers``), over the node list of the port's
    own model file."""
    from .ff import espaloma

    return espaloma.EspalomaGNN(espaloma._graph(), initializers, device=torch.device(device))
