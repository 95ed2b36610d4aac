"""Lipid membrane analysis: patches, normals, curvature, areas, order.

The port's own copy of ``molar_tpu.membrane.membrane``, the host pipeline
(numpy, f32 coordinates with f64 fits and Voronoi work, as the JAX
package's); its options and group statistics are those of :mod:`.stats`,
which :class:`~.device.MembraneDevice` folds into as well (reference:
molar_membrane/src/{lib,lipid_molecule,lipid_species}.rs). TOML-configured
per-species lipid definitions; per frame:

1. per-lipid unwrap + head/mid/tail markers (COMs of marker selections);
2. patches = PBC cell-grid search over head markers within ``cutoff``
   (default 2.5 nm);
3. initial normals: normalized tail->head vectors, then two passes of
   angular-filtered (<= pi/2) patch averaging;
4. ``max_smooth_iter`` rounds of smoothing: local frame from the normal,
   min-image-unwrapped patch in local coords, quadric fit
   ``z = Ax^2 + By^2 + Cxy + Dx + Ey + F`` via 6x6 normal equations,
   2D Voronoi cell for direct neighbors + in-plane area (triangle fan over
   surface-projected vertices), mean/Gaussian/principal curvature from the
   fundamental forms, marker update by the fitted height (invalid if > 0.5 nm
   or the patch touches the Voronoi wall), then marker averaging over fitted
   patch projections;
5. per-tail order parameters (Sz/Scd/ScdCorr) with the lipid or global normal;
6. optional n-shell curvature smoothing; per-group running statistics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.pbc import PBC_FULL
from ..core.system import Sel, System
from ..ops import measure_host, neighbor_host
from ..ops.voronoi import voronoi_cells_batch
from .stats import LipidGroup, MembraneError, MembraneOptions, merge_groups


class LipidSpecies:
    """Per-species atom-offset template built from the first instance
    (lipid_species.rs: tail strings 'C1-C2=C3...' parse into offsets +
    bond orders)."""

    def __init__(self, name: str, descr: dict, first_lipid: Sel):
        self.name = name
        self.whole = descr["whole"]
        first_index = int(first_lipid.indices[0])
        self.head_offsets = first_lipid.select(descr["head"]).indices - first_index
        self.mid_offsets = first_lipid.select(descr["mid"]).indices - first_index
        self.max_area = float(descr.get("max_area", 0.0))
        self.tails: list[tuple[np.ndarray, np.ndarray]] = []
        for t in descr.get("tails", []):
            names: list[str] = []
            orders: list[int] = []
            cur = t
            while True:
                cut = min(
                    [i for i in (cur.find("-"), cur.find("=")) if i >= 0],
                    default=-1,
                )
                if cut < 0:
                    break
                if cut == 0:
                    raise MembraneError(f"missing carbon atom name in tail {t!r}")
                names.append(cur[:cut])
                orders.append(1 if cur[cut] == "-" else 2)
                cur = cur[cut + 1 :]
            if not cur:
                raise MembraneError(f"missing last carbon atom name in tail {t!r}")
            names.append(cur)
            offsets = []
            for nm in names:
                a = first_lipid.select(f"name {nm}")
                if len(a) != 1:
                    raise MembraneError(f"tail atom {nm} not unique in lipid")
                offsets.append(int(a.indices[0]) - first_index)
            self.tails.append(
                (np.asarray(offsets, np.int64), np.asarray(orders, np.int64))
            )
        # tail end = last carbon of each tail
        self.tail_end_offsets = np.asarray(
            [t[0][-1] for t in self.tails] or [0], np.int64
        )


class LipidMolecule:
    def __init__(self, lipid_id: int, sel: Sel, species: LipidSpecies):
        self.id = lipid_id
        self.sel = sel
        self.species = species
        first = int(sel.indices[0])
        self.head_idx = sel.indices[0] + species.head_offsets
        self.mid_idx = sel.indices[0] + species.mid_offsets
        self.tail_end_idx = sel.indices[0] + species.tail_end_offsets
        self.valid = True
        self.head_marker = np.zeros(3)
        self.mid_marker = np.zeros(3)
        self.tail_marker = np.zeros(3)
        self.tail_head_vec = np.zeros(3)
        self.normal = np.array([0.0, 0.0, 1.0])
        self.patch_ids: list[int] = []
        self.neib_ids: list[int] = []
        self.fitted_patch_points: list[np.ndarray] = []
        self.voro_vertexes: list[np.ndarray] = []
        self.mean_curv = 0.0
        self.gaussian_curv = 0.0
        self.princ_curvs = np.zeros(2)
        self.princ_dirs = np.zeros((3, 2))
        self.area = 0.0
        self.order: list[np.ndarray] = [
            np.zeros(max(len(t[0]) - 2, 0)) for t in species.tails
        ]

    def update_markers(self, system: System) -> None:
        """Unwrap the lipid and recompute COM markers."""
        self.sel.unwrap_simple()
        coords = system.state.coords
        masses = system.topology.mass
        self.head_marker = measure_host.center(
            coords[self.head_idx], masses[self.head_idx]
        )
        self.mid_marker = measure_host.center(coords[self.mid_idx], masses[self.mid_idx])
        self.tail_marker = measure_host.center(
            coords[self.tail_end_idx], masses[self.tail_end_idx]
        )

    def to_lab_transform(self) -> np.ndarray:
        """Local->lab matrix (columns n x x-hat, n x (n x x-hat), -n;
        lipid_molecule.rs:190-196 — deliberately not orthonormalized)."""
        n = self.normal
        c0 = np.cross(n, [1.0, 0.0, 0.0])
        c1 = np.cross(n, c0)
        return np.stack([c0, c1, -n], axis=1)

    def compute_curvature_and_normal(self, coefs: np.ndarray, to_lab: np.ndarray):
        a, b, c, d, e, _f = coefs
        E = 1 + d * d
        F = d * e
        G = 1 + e * e
        L = 2 * a
        M = c
        N = 2 * b
        Z = E * G - F * F
        self.gaussian_curv = (L * N - M * M) / Z
        self.mean_curv = 0.5 * (E * N - 2 * F * M + G * L) / Z
        v = np.array([d, e, -1.0])
        self.normal = to_lab @ (v / np.linalg.norm(v))
        W = np.array(
            [[E * L - F * M, E * M - F * N], [G * M - F * L, G * N - F * M]]
        ) / Z
        vals, vecs = np.linalg.eigh(0.5 * (W + W.T))
        self.princ_curvs = vals
        self.princ_dirs = np.stack(
            [
                to_lab @ np.array([vecs[0, 0], vecs[1, 0], 0.0]),
                to_lab @ np.array([vecs[0, 1], vecs[1, 1], 0.0]),
            ],
            axis=1,
        )

    def compute_order(self, system: System, order_type: str, global_normal):
        normal = global_normal if global_normal is not None else self.normal
        coords = system.state.coords
        first = self.sel.indices[0]
        for k, (offsets, orders) in enumerate(self.species.tails):
            tail_coords = coords[first + offsets]
            self.order[k] = measure_host.lipid_tail_order(
                order_type, tail_coords, normal.reshape(1, 3), orders
            )


def get_quad_coefs(local_points: np.ndarray) -> Optional[np.ndarray]:
    """Least-squares quadric z = Ax^2+By^2+Cxy+Dx+Ey+F (lib.rs:844-866)."""
    x, y, z = local_points[:, 0], local_points[:, 1], local_points[:, 2]
    P = np.stack([x * x, y * y, x * y, x, y, np.ones_like(x)], axis=1)
    m = P.T @ P
    rhs = P.T @ z
    try:
        c = np.linalg.cholesky(m)
    except np.linalg.LinAlgError:
        return None
    return np.linalg.solve(m, rhs)


def _z_surf(x, y, c):
    return c[0] * x * x + c[1] * y * y + c[2] * x * y + c[3] * x + c[4] * y + c[5]


class Membrane:
    def __init__(self, system: System, options: str | MembraneOptions):
        if isinstance(options, str):
            options = MembraneOptions.from_toml(options)
        self.options = options
        self.system = system
        src = system.select(options.sel)
        self.lipids: list[LipidMolecule] = []
        self.resindex_to_id: dict[int, int] = {}
        self.species: list[LipidSpecies] = []
        for name, descr in options.lipids.items():
            try:
                lips_sel = src.select(descr["whole"])
            except Exception:
                continue
            per_lipid = lips_sel.split_resindex()
            if not per_lipid:
                continue
            sp = LipidSpecies(name, descr, per_lipid[0])
            self.species.append(sp)
            for lsel in per_lipid:
                lid = len(self.lipids)
                self.lipids.append(LipidMolecule(lid, lsel, sp))
                self.resindex_to_id[
                    int(system.topology.resindex[lsel.indices[0]])
                ] = lid
        if not self.lipids:
            raise MembraneError("no lipids matched the configured species")
        # Named groups start empty; membership is added by the caller
        # (add_ids_to_group) — e.g. leaflets split by marker z.
        self.groups: dict[str, LipidGroup] = {
            name: LipidGroup(name) for name in (options.groups or ["all"])
        }
        if "all" in self.groups and not options.groups:
            self.add_ids_to_group("all", [l.id for l in self.lipids])

    def add_ids_to_group(self, name: str, ids) -> None:
        gr = self.groups.get(name)
        if gr is None:
            raise MembraneError(f"no such group {name!r}")
        for i in ids:
            if not 0 <= i < len(self.lipids):
                raise MembraneError(f"lipid id {i} out of bounds")
            if not self.lipids[i].valid:
                continue
            gr.lipid_ids.append(int(i))
        gr.species_names = sorted(
            {self.lipids[i].species.name for i in gr.lipid_ids}
        )
        gr._init_stats()

    # reference python-binding name (membrane_order.py workflow)
    add_lipids_to_group = add_ids_to_group

    def set_state(self, state) -> None:
        """Swap a new frame into the analyzed system (reference
        Membrane.set_state); call before :meth:`compute` per frame."""
        self.system.set_state(state)

    def reset_groups(self) -> None:
        for gr in self.groups.values():
            gr.lipid_ids.clear()
            gr._init_stats()

    def reset_valid_lipids(self) -> None:
        for l in self.lipids:
            l.valid = True

    # -- per-frame pipeline --------------------------------------------------

    def compute(self) -> None:
        sys = self.system
        box = sys.state.require_box()
        for lip in self.lipids:
            lip.valid = True
        self._update_markers_all()
        self._compute_patches(self.options.cutoff)
        self._initial_normals()
        for it in range(max(self.options.max_smooth_iter, 1)):
            if self.options.n_shells_patch > 0 and it == 0:
                self._smooth()
                self._patches_from_nth_shell(self.options.n_shells_patch)
            self._smooth()
        self._compute_order_all()
        self._smooth_curvature(self.options.n_shells_smoothing)
        for gr in self.groups.values():
            gr.frame_update(self.lipids)

    def finalize(self) -> None:
        for gr in self.groups.values():
            gr.save(self.options.output_dir)

    def merge_stats_from(self, other: "Membrane") -> None:
        """Fold another Membrane's accumulated group statistics into this one.

        The frame-sharded shape of the membrane workload: each shard streams
        its slice of the trajectory through its own Membrane and the
        per-group Welford accumulators merge exactly afterwards
        (order-independent up to float rounding). Groups and species must
        match.
        """
        merge_groups(self.groups, other.groups)

    def write_vmd_visualization(self, path: str) -> None:
        """TCL graphics: markers, tail-head vectors, fitted normals, Voronoi
        cells (reference lib.rs write_vmd_visualization)."""
        from .vmd_visual import VmdVisual

        vis = VmdVisual()
        for lip in self._valid():
            vis.sphere(lip.head_marker, 0.8, "white")
            vis.arrow(lip.head_marker, lip.tail_head_vec, "yellow")
            vis.sphere(lip.head_marker, 0.8, "red")
            vis.arrow(lip.head_marker, lip.normal, "orange")
            n = len(lip.voro_vertexes)
            for i in range(n):
                vis.cylinder(
                    lip.voro_vertexes[i], lip.voro_vertexes[(i + 1) % n], "green"
                )
            for p in lip.fitted_patch_points:
                vis.sphere(p, 0.3, "green")
        vis.save(path)

    # -- internals ------------------------------------------------------------
    #
    # The per-frame pipeline is batched over the lipid axis (arrays over all
    # lipids + one padded patch matrix) instead of per-lipid Python loops —
    # the numpy expression of the reference's rayon par_iter_mut over
    # lipids (molar_membrane/src/lib.rs:661-760). Only the 2D Voronoi
    # half-plane clipping stays per-lipid. Results are written back onto the
    # LipidMolecule objects, so outputs are unchanged.

    def _valid(self):
        return [l for l in self.lipids if l.valid]

    def _lipid_atom_arrays(self):
        """Cached concatenated per-lipid atom/marker index arrays."""
        if not hasattr(self, "_atom_cache"):
            firsts = np.array(
                [int(l.sel.indices[0]) for l in self.lipids], np.int64
            )
            atom_idx = np.concatenate([l.sel.indices for l in self.lipids])
            atom_first = np.concatenate(
                [
                    np.full(len(l.sel.indices), f, np.int64)
                    for l, f in zip(self.lipids, firsts)
                ]
            )

            def marker(idx_of):
                idx = np.concatenate([idx_of(l) for l in self.lipids])
                seg = np.concatenate(
                    [
                        np.full(len(idx_of(l)), i, np.int64)
                        for i, l in enumerate(self.lipids)
                    ]
                )
                return idx, seg

            self._atom_cache = (
                atom_idx,
                atom_first,
                marker(lambda l: l.head_idx),
                marker(lambda l: l.mid_idx),
                marker(lambda l: l.tail_end_idx),
            )
        return self._atom_cache

    def _update_markers_all(self) -> None:
        """Batched unwrap + marker COMs (was per-lipid update_markers)."""
        sys = self.system
        box = sys.state.require_box()
        coords = sys.state.coords
        masses = sys.topology.mass
        atom_idx, atom_first, head, mid, tail = self._lipid_atom_arrays()
        # unwrap_simple per lipid: every atom to the closest image of its
        # lipid's first atom (modify.rs unwrap_simple semantics).
        ref = coords[atom_first]
        coords[atom_idx] = ref + box.shortest_vector(coords[atom_idx] - ref)
        n = len(self.lipids)

        def seg_com(idx, seg):
            w = masses[idx].astype(np.float64)
            wsum = np.bincount(seg, weights=w, minlength=n)
            out = np.empty((n, 3))
            for d in range(3):
                out[:, d] = np.bincount(
                    seg, weights=w * coords[idx, d], minlength=n
                )
            return out / wsum[:, None]

        heads = seg_com(*head)
        mids = seg_com(*mid)
        tails = seg_com(*tail)
        for i, l in enumerate(self.lipids):
            l.head_marker = heads[i]
            l.mid_marker = mids[i]
            l.tail_marker = tails[i]

    def _padded_patches(self):
        """(pid (L,P) padded with -1, mask (L,P)) from per-lipid patch_ids."""
        n = len(self.lipids)
        P = max((len(l.patch_ids) for l in self.lipids), default=0)
        pid = np.full((n, max(P, 1)), -1, np.int64)
        for i, l in enumerate(self.lipids):
            if l.patch_ids:
                pid[i, : len(l.patch_ids)] = l.patch_ids
        return pid, pid >= 0

    def _compute_patches(self, cutoff: float) -> None:
        box = self.system.state.require_box()
        valid = self._valid()
        markers = np.asarray([l.head_marker for l in valid], dtype=np.float32)
        ids = [l.id for l in valid]
        for lip in self.lipids:
            lip.patch_ids = []
        if len(markers) < 2:
            return
        m = len(markers)
        if m <= 512:
            # Brute-force min-image O(m^2) beats the cell-grid machinery at
            # marker counts this small (markers = lipids, not atoms): this
            # is a per-frame call and the grid path cost ~4 ms at m=72.
            d = markers[:, None, :].astype(np.float64) - markers[None, :, :]
            d = box.shortest_vector(d.reshape(-1, 3)).reshape(m, m, 3)
            adj = (d * d).sum(-1) <= float(cutoff) ** 2
            np.fill_diagonal(adj, False)
            for a, b in zip(*np.nonzero(np.triu(adj))):
                self.lipids[ids[a]].patch_ids.append(ids[b])
                self.lipids[ids[b]].patch_ids.append(ids[a])
            return
        pairs, _ = neighbor_host.search_pairs(
            cutoff, markers, np.arange(len(markers)), None, box, PBC_FULL
        )
        for a, b in pairs:
            self.lipids[ids[a]].patch_ids.append(ids[b])
            self.lipids[ids[b]].patch_ids.append(ids[a])

    def _initial_normals(self) -> None:
        valid = np.array([l.valid for l in self.lipids], bool)
        heads = np.stack([l.head_marker for l in self.lipids])
        tails = np.stack([l.tail_marker for l in self.lipids])
        v = heads - tails
        thv = v / np.linalg.norm(v, axis=1, keepdims=True)
        for i, l in enumerate(self.lipids):
            if valid[i]:
                l.tail_head_vec = thv[i]
        pid, pmask = self._padded_patches()
        pid_s = np.maximum(pid, 0)
        vecs = np.where(valid[:, None], thv, 0.0)  # garbage rows never used
        for passes in range(2):
            # angular filter arccos(cos) <= pi/2  <=>  cos >= 0
            other = vecs[pid_s]  # (L, P, 3)
            cos = np.einsum("lpd,ld->lp", other, vecs)
            keep = pmask & (cos >= 0)
            acc = vecs + np.where(keep[..., None], other, 0.0).sum(axis=1)
            norm = np.linalg.norm(acc, axis=1, keepdims=True)
            vecs = acc / np.where(norm == 0, 1.0, norm)
            for i, l in enumerate(self.lipids):
                if valid[i]:
                    l.normal = vecs[i]
            # pass 1 reads the freshly written normals; `vecs` already is
            # that array (patch ids only ever reference valid lipids)

    def _smooth(self) -> None:
        box = self.system.state.require_box()
        nl = len(self.lipids)
        saved = np.stack([np.asarray(l.head_marker, np.float64) for l in self.lipids])
        valid = np.array([l.valid for l in self.lipids], bool)
        counts = np.array([len(l.patch_ids) for l in self.lipids])
        for i, l in enumerate(self.lipids):
            if valid[i] and counts[i] == 0:
                l.valid = False
                valid[i] = False
        pid, pmask = self._padded_patches()
        pid_s = np.maximum(pid, 0)

        # Local frames (to_lab columns n x ex, n x (n x ex), -n; deliberately
        # not orthonormal — lipid_molecule.rs:190-196) and their inverses.
        normals = np.stack([np.asarray(l.normal, np.float64) for l in self.lipids])
        c0 = np.cross(normals, np.array([1.0, 0.0, 0.0]))
        c1 = np.cross(normals, c0)
        to_lab = np.stack([c0, c1, -normals], axis=2)  # (L,3,3), columns
        det = np.linalg.det(to_lab)
        sing = ~np.isfinite(det) | (np.abs(det) < 1e-12)
        for i, l in enumerate(self.lipids):
            if valid[i] and sing[i]:
                l.valid = False
                valid[i] = False
        to_local = np.linalg.inv(np.where(sing[:, None, None], np.eye(3), to_lab))

        # Min-image patch displacements (f32 cast matches the reference's
        # Float path) and local coordinates, batched over (L, P).
        rel = (saved[pid_s] - saved[:, None, :]).astype(np.float32)
        rel = box.shortest_vector(rel).astype(np.float64)
        local = np.einsum("lij,lpj->lpi", to_local, rel)

        # Quadric fit z = Ax^2+By^2+Cxy+Dx+Ey+F via masked 6x6 normal
        # equations, batched (lib.rs:844-866 / get_quad_coefs).
        x, y, z = local[..., 0], local[..., 1], local[..., 2]
        Pm = np.stack([x * x, y * y, x * y, x, y, np.ones_like(x)], axis=-1)
        Pm = np.where(pmask[..., None], Pm, 0.0)
        zm = np.where(pmask, z, 0.0)
        M = np.einsum("lpi,lpj->lij", Pm, Pm)
        rhs = np.einsum("lpi,lp->li", Pm, zm)
        # cholesky-succeeds check, batched: all eigenvalues > 0
        pd = np.linalg.eigvalsh(np.where(valid[:, None, None], M, np.eye(6)))[
            :, 0
        ] > 0
        for i, l in enumerate(self.lipids):
            if valid[i] and not pd[i]:
                l.valid = False
                valid[i] = False
        coefs = np.linalg.solve(
            np.where((valid & pd)[:, None, None], M, np.eye(6)), rhs[..., None]
        )[..., 0]

        # Per-lipid Voronoi (half-plane clipping stays host-sequential),
        # then batched curvature/area/marker updates written back.
        a, b, c, d, e, f = (coefs[:, k] for k in range(6))
        E = 1 + d * d
        F = d * e
        G = 1 + e * e
        Lq = 2 * a
        Mq = c
        Nq = 2 * b
        Z = np.where(valid, E * G - F * F, 1.0)
        gaussian = (Lq * Nq - Mq * Mq) / Z
        meanc = 0.5 * (E * Nq - 2 * F * Mq + G * Lq) / Z
        vnorm = np.stack([d, e, -np.ones_like(d)], axis=1)
        vnorm /= np.linalg.norm(vnorm, axis=1, keepdims=True)
        new_normals = np.einsum("lij,lj->li", to_lab, vnorm)
        W = (
            np.stack(
                [
                    np.stack([E * Lq - F * Mq, E * Mq - F * Nq], axis=1),
                    np.stack([G * Mq - F * Lq, G * Nq - F * Mq], axis=1),
                ],
                axis=1,
            )
            / Z[:, None, None]
        )
        wvals, wvecs = np.linalg.eigh(0.5 * (W + np.swapaxes(W, 1, 2)))

        # fitted patch projections: saved[j] + (z_surf - z) * to_lab[:, 2]
        zs = (
            a[:, None] * x * x
            + b[:, None] * y * y
            + c[:, None] * x * y
            + d[:, None] * x
            + e[:, None] * y
            + f[:, None]
        )
        fit_pts = saved[pid_s] + (zs - z)[..., None] * to_lab[:, None, :, 2]

        # ALL lipids' Voronoi cells clip in one batched Sutherland-Hodgman
        # sweep (bit-identical to the per-lipid VoronoiCell loop — the
        # reference parallelizes exactly this loop, lib.rs:661-760).
        vb, ebids, cb = voronoi_cells_batch(
            local[:, :, :2], pid_s, pmask & valid[:, None],
            -10.0, 10.0, -10.0, 10.0,
        )
        # Batched polygon geometry over the padded (L, V) cells: surface
        # lift, lab-frame vertices, shoelace area (same per-edge summation
        # order as the scalar form — bit-compatible).
        V = vb.shape[1]
        mvalid = np.arange(V)[None, :] < cb[:, None]
        v2x, v2y = vb[:, :, 0], vb[:, :, 1]
        zs_all = _z_surf(v2x, v2y, coefs.T[:, :, None])
        voro_all = np.einsum(
            "lij,lvj->lvi", to_lab, np.stack([v2x, v2y, zs_all], axis=-1)
        )
        idxV = np.arange(V)[None, :]
        nxt_i = np.where(idxV + 1 < cb[:, None], idxV + 1, 0)
        nxt_all = np.take_along_axis(voro_all, nxt_i[:, :, None], axis=1)
        cr = np.cross(voro_all, nxt_all)
        areas_all = 0.5 * np.where(
            mvalid, np.linalg.norm(cr, axis=2), 0.0
        ).sum(axis=1)

        for i, lip in enumerate(self.lipids):
            if not valid[i]:
                continue
            n_p = counts[i]
            m = int(cb[i])
            vert_ids = ebids[i, :m]
            lip.neib_ids = [int(k) for k in vert_ids if k >= 0]
            if len(lip.neib_ids) < m:
                lip.valid = False  # patch touches the bounding wall
                valid[i] = False
                continue
            # curvature + normal (compute_curvature_and_normal, batched above)
            lip.gaussian_curv = gaussian[i]
            lip.mean_curv = meanc[i]
            lip.normal = new_normals[i]
            lip.princ_curvs = wvals[i]
            lip.princ_dirs = np.stack(
                [
                    to_lab[i] @ np.array([wvecs[i, 0, 0], wvecs[i, 1, 0], 0.0]),
                    to_lab[i] @ np.array([wvecs[i, 0, 1], wvecs[i, 1, 1], 0.0]),
                ],
                axis=1,
            )
            lip.voro_vertexes = list(voro_all[i, :m])
            lip.area = areas_all[i]
            lip.fitted_patch_points = list(fit_pts[i, :n_p])
            if abs(coefs[i, 5]) > 0.5:
                lip.valid = False
                valid[i] = False
                continue
            lip.head_marker = saved[i] + coefs[i, 5] * to_lab[i, :, 2]

        # marker smoothing over fitted patch projections (batched scatter)
        smooth_n = np.ones(nl)
        smooth_p = np.stack([np.asarray(l.head_marker, np.float64) for l in self.lipids])
        ok = valid[:, None] & pmask
        np.add.at(smooth_n, pid_s[ok], 1.0)
        np.add.at(smooth_p, pid_s[ok], fit_pts[ok])
        for lip in self._valid():
            lip.head_marker = smooth_p[lip.id] / smooth_n[lip.id]
        for lip in self._valid():
            lip.voro_vertexes = [v + lip.head_marker for v in lip.voro_vertexes]

    def _compute_order_all(self) -> None:
        """Species-grouped batched tail order parameters.

        Replaces the per-lipid ``compute_order`` loop (which paid one numpy
        dispatch chain per lipid per tail) with ONE
        ``lipid_tail_order_batch`` call per (species, tail) — the batched
        expression of the reference's per-lipid order computation
        (molar_membrane/src/lib.rs). ``LipidMolecule.compute_order`` remains
        as the single-lipid reference path.
        """
        coords = self.system.state.coords
        gn = self.options.global_normal
        by_sp: dict[str, list] = {}
        for lip in self.lipids:
            if lip.valid:
                by_sp.setdefault(lip.species.name, []).append(lip)
        for lips in by_sp.values():
            sp = lips[0].species
            firsts = np.array([l.sel.indices[0] for l in lips])
            if gn is not None:
                normals = np.asarray(gn, np.float64).reshape(1, 3)
            else:
                normals = np.stack([np.asarray(l.normal, np.float64) for l in lips])
            for k, (offsets, orders) in enumerate(sp.tails):
                tc = coords[firsts[:, None] + np.asarray(offsets)[None, :]]
                vals = measure_host.lipid_tail_order_batch(
                    self.options.order_type, tc, normals, orders
                )
                for r, l in enumerate(lips):
                    l.order[k] = vals[r]

    def _patches_from_nth_shell(self, n_neib: int) -> None:
        if n_neib < 1:
            return
        for lip in self._valid():
            shell = set(lip.neib_ids)
            for _ in range(2, n_neib + 1):
                for x in list(shell):
                    shell.update(self.lipids[x].neib_ids)
            lip.patch_ids = sorted(shell)

    def _smooth_curvature(self, n_neib: int) -> None:
        if n_neib < 1:
            return
        mean = [l.mean_curv for l in self.lipids]
        gauss = [l.gaussian_curv for l in self.lipids]
        for lip in self._valid():
            shell = set(lip.neib_ids)
            for _ in range(2, n_neib + 1):
                for x in list(shell):
                    shell.update(self.lipids[x].neib_ids)
            vals = [j for j in shell if self.lipids[j].valid]
            if vals:
                lip.mean_curv = (mean[lip.id] + sum(mean[j] for j in vals)) / (
                    len(vals) + 1
                )
                lip.gaussian_curv = (gauss[lip.id] + sum(gauss[j] for j in vals)) / (
                    len(vals) + 1
                )


def split_leaflets(membrane: Membrane) -> tuple[list, list]:
    """The ``membrane`` command's leaflet split on the system's current
    frame: every lipid's markers updated (each lipid unwrapped in place),
    the lipids whose head marker's z lies above the median of them all in
    the upper leaflet, the rest in the lower. The two go into groups
    ``upper`` and ``lower`` when the options name both. -> (upper ids,
    lower ids)."""
    for lip in membrane.lipids:
        lip.update_markers(membrane.system)
    z0 = float(np.median([l.head_marker[2] for l in membrane.lipids]))
    upper = [l.id for l in membrane.lipids if l.head_marker[2] > z0]
    lower = [l.id for l in membrane.lipids if l.head_marker[2] <= z0]
    if "upper" in membrane.groups and "lower" in membrane.groups:
        membrane.add_ids_to_group("upper", upper)
        membrane.add_ids_to_group("lower", lower)
    return upper, lower
