"""SAS / SES triangle meshes (reference: powersasa meshes via molar sasa.rs:14-122).

The port's own copy of ``molar_tpu.ops.surface`` (no JAX).

The reference exposes solvent-accessible (SAS) and solvent-excluded (SES)
triangle meshes from its power-diagram SASA engine. Here the meshes come from
an isosurface of a voxelized distance field instead — the EDTSurf-style
formulation, which is simple, robust and vectorizes well:

* SAS: zero isosurface of ``f(p) = min_i (|p - x_i| - (r_i + probe))``.
* SES: roll the probe back in — the surface at depth ``probe`` inside the SAS
  union, i.e. the zero isosurface of ``probe - EDT(p)`` where EDT is the
  Euclidean distance transform measured from the SAS boundary inward.

The isosurface is extracted with marching tetrahedra (each voxel cube split
into 6 tetrahedra; 16-case table) — much smaller tables than marching cubes
and no ambiguous cases. Triangle orientation is not normalized; areas and
enclosed volumes (via the divergence theorem) are orientation-independent the
way they are computed here.

Everything is host-side numpy: mesh extraction is irregular, output-size
dynamic work that belongs on CPU (the per-atom SASA *numbers* have their own
device path in ops/sasa.py).
"""

from __future__ import annotations

import numpy as np

# Tetrahedral decomposition of a cube. Corner ids are bit-coded (x=1, y=2,
# z=4); each cube is split into 6 tets sharing the main diagonal 0-7.
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 7, 5],
        [0, 5, 7, 4],
        [0, 4, 7, 6],
        [0, 6, 7, 2],
        [0, 2, 7, 3],
    ],
    dtype=np.int64,
)

# The 6 edges of a tetrahedron as (corner, corner) pairs.
_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# case index = sum over inside corners i of 2**i; each case yields up to two
# triangles given as triples of edge ids into _EDGES (-1 = unused).
_CASES = -np.ones((16, 2, 3), dtype=np.int64)
_CASES[1, 0] = (0, 1, 2)
_CASES[2, 0] = (0, 4, 3)
_CASES[3] = [(1, 2, 4), (1, 4, 3)]
_CASES[4, 0] = (1, 3, 5)
_CASES[5] = [(0, 2, 5), (0, 5, 3)]
_CASES[6] = [(0, 4, 5), (0, 5, 1)]
_CASES[7, 0] = (2, 4, 5)
_CASES[8, 0] = (2, 5, 4)
_CASES[9] = [(0, 1, 5), (0, 5, 4)]
_CASES[10] = [(0, 3, 5), (0, 5, 2)]
_CASES[11, 0] = (1, 3, 5)
_CASES[12] = [(1, 2, 4), (1, 4, 3)]
_CASES[13, 0] = (0, 3, 4)
_CASES[14, 0] = (0, 1, 2)


def marching_tetrahedra(values, origin, spacing):
    """Zero-isosurface triangles of a scalar grid ``values`` (nx, ny, nz).

    Returns (verts (V, 3), tris (T, 3) int32). Vertices are not deduplicated
    (each triangle owns its corners); use :func:`dedupe_mesh` if a shared-
    vertex mesh is needed.
    """
    vals = np.asarray(values, dtype=np.float64)
    nx, ny, nz = vals.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float64), np.zeros((0, 3), np.int32)

    # Corner values for every cube: (8, cx, cy, cz)
    c = np.empty((8, nx - 1, ny - 1, nz - 1), np.float64)
    for cid in range(8):
        dx, dy, dz = cid & 1, (cid >> 1) & 1, (cid >> 2) & 1
        c[cid] = vals[dx : dx + nx - 1, dy : dy + ny - 1, dz : dz + nz - 1]
    c = c.reshape(8, -1)  # (8, n_cubes)

    # Only cubes straddling the isosurface contribute.
    neg = c < 0.0
    active = np.nonzero(neg.any(0) & (~neg).any(0))[0]
    if active.size == 0:
        return np.zeros((0, 3), np.float64), np.zeros((0, 3), np.int32)
    c = c[:, active]

    # Cube corner positions (8, n_active, 3)
    cyz = (ny - 1) * (nz - 1)
    ix = active // cyz
    iy = (active % cyz) // (nz - 1)
    iz = active % (nz - 1)
    base = np.stack([ix, iy, iz], axis=1).astype(np.float64)
    offs = np.array(
        [[cid & 1, (cid >> 1) & 1, (cid >> 2) & 1] for cid in range(8)],
        dtype=np.float64,
    )
    corner_pos = (base[None, :, :] + offs[:, None, :]) * np.asarray(spacing) + np.asarray(
        origin
    )

    tris_out = []
    for tet in _TETS:
        tv = c[tet]  # (4, n_active)
        case = ((tv < 0.0).astype(np.int64) * (1 << np.arange(4))[:, None]).sum(0)
        # Edge crossing points for all 6 edges of this tet: (6, n_active, 3)
        pa = corner_pos[tet[_EDGES[:, 0]]]
        pb = corner_pos[tet[_EDGES[:, 1]]]
        va = tv[_EDGES[:, 0]]
        vb = tv[_EDGES[:, 1]]
        denom = va - vb
        t = np.where(np.abs(denom) > 1e-300, va / np.where(denom == 0, 1, denom), 0.5)
        t = np.clip(t, 0.0, 1.0)
        pts = pa + t[:, :, None] * (pb - pa)
        # Outward reference direction per tet: inside-corner centroid ->
        # outside-corner centroid (used to normalize triangle winding so
        # signed volumes work).
        inside = (tv < 0.0).astype(np.float64)  # (4, n_active)
        tpos = corner_pos[tet]  # (4, n_active, 3)
        n_in = np.maximum(inside.sum(0), 1.0)
        n_out = np.maximum((1.0 - inside).sum(0), 1.0)
        cent_in = (tpos * inside[:, :, None]).sum(0) / n_in[:, None]
        cent_out = (tpos * (1.0 - inside)[:, :, None]).sum(0) / n_out[:, None]
        outward = cent_out - cent_in  # (n_active, 3)
        for slot in range(2):
            eids = _CASES[case, slot]  # (n_active, 3)
            keep = np.nonzero(eids[:, 0] >= 0)[0]
            if keep.size == 0:
                continue
            tri = np.moveaxis(pts[eids[keep].T, keep], 0, 1)  # (n_keep, 3, 3)
            normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            flip = np.einsum("ij,ij->i", normal, outward[keep]) < 0.0
            tri[flip] = tri[flip][:, [0, 2, 1]]
            tris_out.append(tri)
    if not tris_out:
        return np.zeros((0, 3), np.float64), np.zeros((0, 3), np.int32)
    tri_pts = np.concatenate(tris_out, axis=0)  # (T, 3, 3)
    verts = tri_pts.reshape(-1, 3)
    tris = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    return verts, tris


def dedupe_mesh(verts, tris, decimals: int = 9):
    """Merge coincident vertices (rounded to ``decimals``)."""
    key = np.round(verts, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    return uniq, inv[tris].astype(np.int32)


def mesh_area(verts, tris) -> float:
    a = verts[tris[:, 1]] - verts[tris[:, 0]]
    b = verts[tris[:, 2]] - verts[tris[:, 0]]
    return float(0.5 * np.linalg.norm(np.cross(a, b), axis=1).sum())


def mesh_volume(verts, tris) -> float:
    """Enclosed volume via the divergence theorem (triangles are emitted with
    consistent outward winding by :func:`marching_tetrahedra`)."""
    p0 = verts[tris[:, 0]]
    p1 = verts[tris[:, 1]]
    p2 = verts[tris[:, 2]]
    return float(abs(np.einsum("ij,ij->i", p0, np.cross(p1, p2)).sum() / 6.0))


def _sas_field(coords, radii, probe, spacing, margin=2):
    """Voxel field min_i(|p - x_i| - (r_i + probe)) via per-atom local updates."""
    coords = np.asarray(coords, np.float64)
    rr = np.asarray(radii, np.float64) + probe
    lo = (coords - rr[:, None]).min(0) - margin * spacing
    hi = (coords + rr[:, None]).max(0) + margin * spacing
    dims = np.maximum(np.ceil((hi - lo) / spacing).astype(int) + 1, 2)
    field = np.full(tuple(dims), 1e30, np.float64)
    axes = [lo[d] + spacing * np.arange(dims[d]) for d in range(3)]
    for i in range(coords.shape[0]):
        r = rr[i]
        i0 = np.maximum(((coords[i] - r - spacing) - lo) / spacing, 0).astype(int)
        i1 = np.minimum(
            ((coords[i] + r + spacing) - lo) / spacing + 1, dims
        ).astype(int)
        if (i1 <= i0).any():
            continue
        dx = axes[0][i0[0] : i1[0]] - coords[i, 0]
        dy = axes[1][i0[1] : i1[1]] - coords[i, 1]
        dz = axes[2][i0[2] : i1[2]] - coords[i, 2]
        d = np.sqrt(
            dx[:, None, None] ** 2 + dy[None, :, None] ** 2 + dz[None, None, :] ** 2
        )
        sub = field[i0[0] : i1[0], i0[1] : i1[1], i0[2] : i1[2]]
        np.minimum(sub, d - r, out=sub)
    return field, lo, spacing


def sas_mesh(coords, radii, probe: float = 0.14, spacing: float = 0.05):
    """Solvent-accessible surface triangle mesh.

    coords/radii in nm (radii = vdW). Returns (verts, tris).
    """
    field, origin, sp = _sas_field(coords, radii, probe, spacing)
    return marching_tetrahedra(field, origin, sp)


def ses_mesh(coords, radii, probe: float = 0.14, spacing: float = 0.05):
    """Solvent-excluded (molecular) surface triangle mesh.

    EDTSurf-style: Euclidean distance transform from the SAS boundary inward,
    isosurface at depth ``probe``. Needs scipy (baked in).
    """
    from scipy.ndimage import distance_transform_edt

    field, origin, sp = _sas_field(coords, radii, probe, spacing)
    inside = field < 0.0
    edt = distance_transform_edt(inside, sampling=sp)
    return marching_tetrahedra(probe - edt, origin, sp)


def write_obj(path: str, verts, tris) -> None:
    """Write a Wavefront OBJ mesh (1-based indices)."""
    with open(path, "w") as fh:
        fh.write("# molar_tpu surface mesh\n")  # the JAX package's header: equal files
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            fh.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
