"""Incremental 2D Voronoi cell for one lipid's patch.

The port's own copy of ``molar_tpu.ops.voronoi`` (no JAX).

Mirrors the reference ``VoronoiCell`` (molar/src/voronoi_cell.rs): the cell of
the point at the ORIGIN, built by successively cutting a bounding rectangle
with the perpendicular bisector half-plane towards each neighbor (cutting line
``(p/2) . x <= |p/2|^2``). Every edge carries the id of the neighbor whose
bisector created it (negative ids = the initial rectangle sides), so direct
neighbors and the in-plane area fall out of the final polygon.

The clip loop runs on plain Python floats (same IEEE-double arithmetic as the
numpy version, measured ~6x faster at polygon sizes of 4-12 — this is the
membrane pipeline's per-lipid hot loop).
"""

from __future__ import annotations

import numpy as np

TOL = 1e-10


class VoronoiCell:
    def __init__(self, xmin: float, xmax: float, ymin: float, ymax: float):
        self.verts = [
            (float(xmin), float(ymin)),
            (float(xmax), float(ymin)),
            (float(xmax), float(ymax)),
            (float(xmin), float(ymax)),
        ]
        # edge_ids[i] = id of the edge from verts[i] to verts[i+1]
        self.edge_ids = [-1, -2, -3, -4]

    def add_point(self, point, neighbor_id: int) -> bool:
        """Cut with the bisector towards ``point``; True if the cell changed."""
        nx = 0.5 * float(point[0])
        ny = 0.5 * float(point[1])
        c = nx * nx + ny * ny
        if c < TOL:
            return False
        verts = self.verts
        d = [nx * vx + ny * vy - c for vx, vy in verts]
        all_in = True
        all_out = True
        for di in d:
            if di < TOL:
                all_out = False
            else:
                all_in = False
        if all_in:
            return False  # all inside, no cut
        if all_out:
            # Degenerate: whole cell clipped away (shouldn't happen for sane
            # patches); keep as-is.
            return False
        m = len(verts)
        edge_ids = self.edge_ids
        out_v: list[tuple[float, float]] = []
        out_id: list[int] = []
        for i in range(m):
            j = i + 1 if i + 1 < m else 0
            da, db = d[i], d[j]
            inside_a = da < TOL
            if inside_a:
                out_v.append(verts[i])
                out_id.append(edge_ids[i])
                if not (db < TOL):
                    t = da / (da - db)
                    ax, ay = verts[i]
                    bx, by = verts[j]
                    out_v.append((ax + t * (bx - ax), ay + t * (by - ay)))
                    out_id.append(neighbor_id)
            elif db < TOL:
                t = da / (da - db)
                ax, ay = verts[i]
                bx, by = verts[j]
                out_v.append((ax + t * (bx - ax), ay + t * (by - ay)))
                out_id.append(edge_ids[i])
        self.verts = out_v
        self.edge_ids = out_id
        return True

    def area(self) -> float:
        """Shoelace area of the cell polygon."""
        v = np.asarray(self.verts)
        if len(v) < 3:
            return 0.0
        x, y = v[:, 0], v[:, 1]
        return float(
            0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))
        )

    def neighbor_ids(self) -> list[int]:
        """Ids of neighbors owning an edge of the final cell (direct
        neighbors); excludes the initial rectangle's negative ids."""
        return sorted({i for i in self.edge_ids if i >= 0})

    def vertices(self):
        """(position (2,) array, outgoing edge id) pairs, counterclockwise."""
        return [(np.array(v), i) for v, i in zip(self.verts, self.edge_ids)]


def voronoi_cells_batch(points, ids, pmask, xmin, xmax, ymin, ymax):
    """Batched half-plane clipping: L independent VoronoiCells at once.

    ``points`` (L, P, 2) float64 — the k-th bisector point of every cell;
    ``ids`` (L, P) int — the neighbor id each cut carries; ``pmask`` (L, P)
    — which cuts exist. Clip step k applies to every cell simultaneously
    (vectorized Sutherland-Hodgman over a padded (L, V) polygon soup); the
    arithmetic is the same IEEE-double expression sequence as
    :meth:`VoronoiCell.add_point`, so results are bit-identical to the
    per-cell loop — this is the membrane pipeline's per-lipid hot loop
    batched over the lipid axis (the reference parallelizes exactly this
    loop with rayon, molar_membrane/src/lib.rs:661-760).

    Returns (verts (L, V, 2), edge_ids (L, V), counts (L,)).
    """
    L, P = pmask.shape
    V = 4 + P + 1  # each cut adds at most one vertex net
    verts = np.zeros((L, V, 2))
    eids = np.full((L, V), 0, np.int64)
    verts[:, 0] = (xmin, ymin)
    verts[:, 1] = (xmax, ymin)
    verts[:, 2] = (xmax, ymax)
    verts[:, 3] = (xmin, ymax)
    eids[:, :4] = (-1, -2, -3, -4)
    counts = np.full(L, 4, np.int64)
    rowsL = np.arange(L)

    for k in range(P):
        nx = 0.5 * points[:, k, 0]
        ny = 0.5 * points[:, k, 1]
        c = nx * nx + ny * ny
        active = pmask[:, k] & (c >= TOL)
        if not active.any():
            continue
        valid = np.arange(V)[None, :] < counts[:, None]  # (L, V)
        d = nx[:, None] * verts[:, :, 0] + ny[:, None] * verts[:, :, 1] - c[:, None]
        inside = d < TOL
        ins_valid = inside & valid
        all_in = (ins_valid == valid).all(axis=1)
        all_out = ~ins_valid.any(axis=1)
        change = active & ~all_in & ~all_out
        if not change.any():
            continue
        # next valid index per slot: j = (i+1) % count
        idx = np.arange(V)[None, :]
        j = np.where(idx + 1 < counts[:, None], idx + 1, 0)
        d_j = np.take_along_axis(d, j, axis=1)
        in_b = d_j < TOL
        crossing = valid & (inside != in_b)
        emit_a = valid & inside
        emit_x = crossing
        # interpolated crossing points
        ax, ay = verts[:, :, 0], verts[:, :, 1]
        bx = np.take_along_axis(ax, j, axis=1)
        by = np.take_along_axis(ay, j, axis=1)
        # Non-crossing slots produce inf/nan t that the interpolation also
        # consumes (those slots are never emitted, but the multiplies would
        # leak RuntimeWarnings to every caller) — keep the whole chain under
        # the errstate guard.
        with np.errstate(invalid="ignore", divide="ignore"):
            t = d / (d - d_j)
            ix = ax + t * (bx - ax)
            iy = ay + t * (by - ay)
        x_id = np.where(inside, ids[:, k][:, None], eids)
        # interleaved emission order per i: [a_i, x_i]
        emit = np.stack([emit_a, emit_x], axis=2).reshape(L, 2 * V)
        pos = np.cumsum(emit, axis=1) - emit  # exclusive prefix = slot
        new_counts = emit.sum(axis=1)
        vx_s = np.stack([ax, ix], axis=2).reshape(L, 2 * V)
        vy_s = np.stack([ay, iy], axis=2).reshape(L, 2 * V)
        id_s = np.stack([eids, x_id], axis=2).reshape(L, 2 * V)
        nverts = np.zeros((L, V, 2))
        nids = np.zeros((L, V), np.int64)
        li, si = np.nonzero(emit)
        slot = pos[li, si]
        keep = slot < V
        li, si, slot = li[keep], si[keep], slot[keep]
        nverts[li, slot, 0] = vx_s[li, si]
        nverts[li, slot, 1] = vy_s[li, si]
        nids[li, slot] = id_s[li, si]
        verts = np.where(change[:, None, None], nverts, verts)
        eids = np.where(change[:, None], nids, eids)
        counts = np.where(change, np.minimum(new_counts, V), counts)
    return verts, eids, counts
