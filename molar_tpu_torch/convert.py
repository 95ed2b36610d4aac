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


def _to_device(a, device, non_blocking: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if non_blocking and torch.device(device).type == "cuda":
        # Pinned staging makes the H2D copy truly asynchronous; the caching
        # host allocator keeps the buffer alive until the copy completes.
        t = t.pin_memory()
    return t.to(device, non_blocking=non_blocking)


def transport_to_torch(window, device, non_blocking: bool = False):
    """One ``TrajectoryReader.iter_windows`` item -> ``(transport, boxes,
    invs)`` on ``device``.

    ``transport`` keeps the wire form: a f32 ``(B, N, 3)`` tensor, the pair
    ``(i16 ints, scale)``, or the triple ``(frame0 i16, deltas i8, scale)``
    (scale a 0-d f32 tensor); :func:`tasks.trajectory.decode_window_coords`
    expands all three bit-exactly.
    """
    coords, boxes, invs = window[0], window[1], window[2]

    def conv(a):
        if isinstance(a, np.generic) or np.ndim(a) == 0:
            a = np.asarray(a, dtype=np.float32)
        return _to_device(a, device, non_blocking)

    transport = tuple(map(conv, coords)) if isinstance(coords, tuple) else conv(coords)
    return transport, conv(boxes), conv(invs)


def from_numpy(ref_coords, masses, protein_idx, box_matrix, cutoff, caps, dims, device,
               search: str = "ghost"):
    """Build the headline :class:`~molar_tpu_torch.headline.FitWithinWindow`
    on ``device`` from numpy inputs. ``caps`` is ``(cap, tgt_cap,
    max_tgt_cells)``. The route is picked here, on the host, from the numpy
    box: a skewed box takes the triclinic correction path; an orthorhombic
    one takes the row kernel with ``search="rows"`` and the ghost-slab
    kernel with ``search="ghost"``."""
    from .headline import FitWithinWindow

    if search not in ("ghost", "rows"):
        raise ValueError(f"search must be 'ghost' or 'rows', got {search!r}")
    if PeriodicBox(box_matrix).is_triclinic:
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
    ).to(device)


def workload_from_numpy(name: str, system, device):
    """Build the selection workload ``name`` (one of
    ``molar_tpu_torch.workloads.WORKLOADS``) on ``device`` from a
    :class:`~molar_tpu_torch.workloads.System` of numpy arrays -> (module,
    subset): the module's buffers index the rows of ``subset``, the sorted
    atom indices its windows ship."""
    from . import workloads as wl
    from .ops.measure import contiguous_segments_dense
    from .ops.neighbor import grid_dims_for

    if name not in wl.WORKLOADS:
        raise ValueError(f"workload must be one of {tuple(wl.WORKLOADS)}, got {name!r}")

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), dtype=FLOAT)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64))

    subset = {
        "ca_rmsd": system.ca,
        "com_splits": system.protein,
        "contacts": np.concatenate([system.protein, system.ligand]),
        "fused": np.unique(np.concatenate([system.ca, system.protein, system.ligand])),
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

    if name == "fused":
        model = wl.Fused(i64(rows(system.ca)), ca_rmsd(), com_splits(), contacts())
    else:
        model = {"ca_rmsd": ca_rmsd, "com_splits": com_splits, "contacts": contacts}[name]()
    return model.to(device), subset
