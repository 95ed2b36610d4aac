"""Host (numpy) geometric measures: centers, gyration, inertia, RMSD, Kabsch.

Numerics follow the reference ``Measure`` trait (molar/src/measure.rs):

* PBC-aware centers accumulate each point's closest image **relative to the
  first atom** of the selection (measure.rs:142-195) — not wrap-then-average;
* gyration/inertia use the min-image displacement from the (PBC) center
  (measure.rs:222-257);
* Kabsch: covariance ``sum m * p2 p1^T``, SVD, reflection fix via
  ``sign(det(U V^T))``, result ``T(cm2) . R . T(-cm1)`` (measure.rs:507-643);
* inertia eigenvalues ascending, third axis = cross of the first two
  (right-handed, measure.rs:592-607);
* zero total mass is an error wherever COM is involved.

These are the ground truth the jitted device kernels
(:mod:`molar_tpu.ops.measure`) are validated against (1e-5 RMSD contract).

The port's copy of ``molar_tpu.ops.measure_host`` (numpy only); ``Sel``'s
measures and the selection language's ``com of`` / ``cog of`` reach it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import NP_FLOAT as FLOAT
from ..core.pbc import PBC_FULL, PbcDims, PeriodicBox


class MeasureError(ValueError):
    pass


def _weights(coords: np.ndarray, weights: Optional[np.ndarray]) -> np.ndarray:
    if weights is None:
        return np.ones(coords.shape[0], dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    if w.sum() == 0.0:
        raise MeasureError("zero total mass")
    return w


def min_max(coords: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return coords.min(axis=0), coords.max(axis=0)


def center(coords: np.ndarray, weights: Optional[np.ndarray] = None) -> np.ndarray:
    """COM (weights=masses) or COG (weights=None)."""
    w = _weights(coords, weights)
    return (w[:, None] * coords.astype(np.float64)).sum(axis=0) / w.sum()


def center_pbc(
    coords: np.ndarray,
    weights: Optional[np.ndarray],
    box: PeriodicBox,
    pbc: PbcDims = PBC_FULL,
) -> np.ndarray:
    """PBC-aware center: average of closest images relative to atom 0."""
    ref = coords[0]
    imgs = ref + box.shortest_vector(coords - ref, pbc)
    return center(imgs, weights)


def gyration(
    coords: np.ndarray,
    masses: np.ndarray,
    box: Optional[PeriodicBox] = None,
    pbc: PbcDims = PBC_FULL,
) -> float:
    """Radius of gyration about the COM (min-image displacements if pbc)."""
    if box is not None:
        c = center_pbc(coords, masses, box, pbc)
        d = box.shortest_vector(coords - c.astype(FLOAT), pbc).astype(np.float64)
    else:
        c = center(coords, masses)
        d = coords.astype(np.float64) - c
    w = _weights(coords, masses)
    return float(np.sqrt((w * np.sum(d * d, axis=1)).sum() / w.sum()))


def inertia_tensor(
    coords: np.ndarray,
    masses: np.ndarray,
    box: Optional[PeriodicBox] = None,
    pbc: PbcDims = PBC_FULL,
) -> tuple[np.ndarray, np.ndarray]:
    """(tensor 3x3, com) about the (PBC) center of mass."""
    if box is not None:
        c = center_pbc(coords, masses, box, pbc)
        d = box.shortest_vector(coords - c.astype(FLOAT), pbc).astype(np.float64)
    else:
        c = center(coords, masses)
        d = coords.astype(np.float64) - c
    m = _weights(coords, masses)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx = (m * (y * y + z * z)).sum()
    yy = (m * (x * x + z * z)).sum()
    zz = (m * (x * x + y * y)).sum()
    xy = -(m * x * y).sum()
    xz = -(m * x * z).sum()
    yz = -(m * y * z).sum()
    t = np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
    return t, c


def inertia(
    coords: np.ndarray,
    masses: np.ndarray,
    box: Optional[PeriodicBox] = None,
    pbc: PbcDims = PBC_FULL,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(moments ascending, axes as columns (right-handed), com)."""
    return inertia_axes(*inertia_tensor(coords, masses, box, pbc))


def inertia_axes(t: np.ndarray, c: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The O(1) tail of :func:`inertia` from its (tensor, com): (moments
    ascending, axes as columns (right-handed), com)."""
    vals, vecs = np.linalg.eigh(t)  # eigh returns ascending already
    axes = vecs.copy()
    axes[:, 2] = np.cross(axes[:, 0], axes[:, 1])  # enforce right-handedness
    return vals, axes, c


def principal_transform(
    coords: np.ndarray,
    masses: np.ndarray,
    box: Optional[PeriodicBox] = None,
    pbc: PbcDims = PBC_FULL,
) -> tuple[np.ndarray, np.ndarray]:
    """(R, t) affine taking the selection to its principal-axes frame about the
    COM (measure.rs:646-649): x -> R (x - com) + com with R = axes^-1."""
    _, axes, com = inertia(coords, masses, box, pbc)
    return principal_from_axes(axes, com)


def principal_from_axes(axes: np.ndarray, com: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The O(1) tail of :func:`principal_transform`: (R, t) from the
    inertia axes and the COM."""
    r = np.linalg.inv(axes)
    return r, com - r @ com


def rmsd(coords1: np.ndarray, coords2: np.ndarray) -> float:
    if coords1.shape != coords2.shape:
        raise MeasureError("rmsd requires selections of equal size")
    d = coords1.astype(np.float64) - coords2.astype(np.float64)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def rmsd_mw(coords1: np.ndarray, coords2: np.ndarray, masses1: np.ndarray) -> float:
    if coords1.shape != coords2.shape:
        raise MeasureError("rmsd requires selections of equal size")
    m = _weights(coords1, masses1)
    d = coords1.astype(np.float64) - coords2.astype(np.float64)
    return float(np.sqrt((m * np.sum(d * d, axis=1)).sum() / m.sum()))


def rot_transform(
    centered1: np.ndarray, centered2: np.ndarray, masses: np.ndarray
) -> np.ndarray:
    """Kabsch rotation R minimizing sum m |R p1 - p2|^2 for centered inputs."""
    m = _weights(centered1, masses)
    cov = (m[:, None] * centered2.astype(np.float64)).T @ centered1.astype(np.float64)
    return rotation_from_covariance(cov)


def rotation_from_covariance(cov: np.ndarray) -> np.ndarray:
    """The O(1) tail of :func:`rot_transform`: the proper rotation of the
    3x3 covariance ``sum m p2 p1^T`` (SVD, reflection fix)."""
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    fix = np.diag([1.0, 1.0, d])
    return u @ fix @ vt


def fit_transform(
    coords1: np.ndarray,
    coords2: np.ndarray,
    masses1: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """(R, t): affine x -> R x + t superimposing sel1 onto sel2
    (mass-weighted by sel1 masses; measure.rs:507-522)."""
    if coords1.shape != coords2.shape:
        raise MeasureError("fit requires selections of equal size")
    m = _weights(coords1, masses1)
    cm1 = center(coords1, m)
    cm2 = center(coords2, m)
    r = rot_transform(coords1 - cm1, coords2 - cm2, m)
    t = cm2 - r @ cm1
    return r, t


def fit_transform_at_origin(
    coords1: np.ndarray, coords2: np.ndarray, masses1: np.ndarray
) -> np.ndarray:
    """Rotation-only fit (no translations; measure.rs fit_transform_at_origin)."""
    if coords1.shape != coords2.shape:
        raise MeasureError("fit requires selections of equal size")
    return rot_transform(coords1, coords2, _weights(coords1, masses1))


def apply_transform(coords: np.ndarray, r: np.ndarray, t: np.ndarray) -> np.ndarray:
    return (coords.astype(np.float64) @ r.T + t).astype(coords.dtype)


# ---------------------------------------------------------------------------
# Lipid tail order parameters (measure.rs:262-422)
# ---------------------------------------------------------------------------


def _angle(a: np.ndarray, b: np.ndarray) -> float:
    c = float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _unit(v: np.ndarray) -> np.ndarray:
    # Degenerate input (zero cross product from perfectly collinear tail
    # carbons) propagates NaN exactly like the reference's normalized();
    # silence only the warning, not the semantics.
    with np.errstate(invalid="ignore", divide="ignore"):
        return v / np.linalg.norm(v)


def lipid_tail_order_batch(
    order_type: str,
    coords: np.ndarray,
    normals: np.ndarray,
    bond_orders: np.ndarray,
) -> np.ndarray:
    """Batched :func:`lipid_tail_order` over a leading lipid axis.

    ``coords`` (L, N, 3) tail carbons of L same-species lipids; ``normals``
    (L, 3) per-lipid (or (1, 3) global, broadcast); ``bond_orders`` (N-1,)
    shared (the species defines the tail chemistry). Returns (L, N-2).

    The per-position branch structure (single vs double bonds) depends only
    on ``bond_orders``, so the position loop stays Python (N is ~4-18) and
    every inner expression vectorizes over the lipid axis — this is the
    batched form of the reference's per-lipid order loop
    (molar_membrane/src/lib.rs order computation), 70x fewer Python/numpy
    dispatches at typical membrane sizes. Scalar `lipid_tail_order` is the
    ground truth it is tested against.
    """
    coords = np.asarray(coords, dtype=np.float64)
    L, n = coords.shape[0], coords.shape[1]
    if n < 3:
        raise MeasureError(f"lipid tail too short: {n} atoms")
    normals = np.asarray(normals, dtype=np.float64)
    if normals.ndim == 1:
        normals = normals.reshape(1, 3)
    if normals.ndim == 2:
        # (L,3) per-lipid or (1,3) global, same normal for every bond
        normals = np.broadcast_to(normals[:, None, :], (L, n - 2, 3))
    if normals.shape[1] not in (1, n - 2):
        raise MeasureError(f"need 1 or {n - 2} normals, got {normals.shape[1]}")
    if normals.shape[1] == 1:
        normals = np.broadcast_to(normals, (L, n - 2, 3))
    if len(bond_orders) != n - 1:
        raise MeasureError(f"need {n - 1} bond orders, got {len(bond_orders)}")

    def unit(v):
        with np.errstate(invalid="ignore", divide="ignore"):
            return v / np.linalg.norm(v, axis=-1, keepdims=True)

    def cosang(a, b):
        c = np.einsum("ld,ld->l", a, b) / (
            np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
        )
        return np.clip(c, -1.0, 1.0)

    order = np.zeros((L, n - 2))
    if order_type == "sz":
        for at in range(1, n - 1):
            v = coords[:, at + 1] - coords[:, at - 1]
            c = cosang(v, normals[:, at - 1])
            order[:, at - 1] = 1.5 * c**2 - 0.5
        return order

    if order_type not in ("scd", "scdcorr"):
        raise MeasureError(f"unknown order type {order_type!r}")
    corr = order_type == "scdcorr"
    for i in range(n - 2):
        if bond_orders[i] == 1:
            if bond_orders[i + 1] == 1:
                p1, p2, p3 = coords[:, i], coords[:, i + 1], coords[:, i + 2]
                local_z = unit(p3 - p1)
                local_x = unit(np.cross(p1 - p2, p3 - p2))
                local_y = np.cross(local_x, local_z)
                nv = normals[:, i]
                sxx = 0.5 * (3 * cosang(local_x, nv) ** 2 - 1)
                syy = 0.5 * (3 * cosang(local_y, nv) ** 2 - 1)
                order[:, i] = -(2 * sxx + syy) / 3.0
        else:
            p1, p2, p3, p4 = (
                coords[:, i - 1],
                coords[:, i],
                coords[:, i + 1],
                coords[:, i + 2],
            )
            a1 = 0.5 * (np.pi - np.arccos(cosang(p1 - p2, p3 - p2)))
            a2 = 0.5 * (np.pi - np.arccos(cosang(p2 - p3, p4 - p3)))
            local_z = unit(p3 - p2)
            local_x = unit(np.cross(p1 - p2, local_z))
            local_y = np.cross(local_x, local_z)
            n1 = normals[:, i]
            szz = 0.5 * (3 * cosang(local_z, n1) ** 2 - 1)
            syy = 0.5 * (3 * cosang(local_y, n1) ** 2 - 1)
            syz = 1.5 * cosang(local_y, n1) * cosang(local_z, n1)
            if corr:
                order[:, i - 1] = -(
                    np.cos(a1) ** 2 * syy
                    + np.sin(a1) ** 2 * szz
                    - 2 * np.cos(a1) * np.sin(a1) * syz
                )
            else:
                order[:, i - 1] = -(
                    szz / 4 + 3 * syy / 4 - np.sqrt(3.0) * syz / 2
                )
            local_x = unit(np.cross(p3 - p4, local_z))
            local_y = np.cross(local_x, local_z)
            # A double bond at the chain end reads the (i+1)-th bond normal;
            # with a single broadcast normal that's the same vector (the
            # scalar form's nrm() semantics) — clip so the broadcast copy
            # doesn't index past the materialized n-2 rows.
            n2 = normals[:, min(i + 1, normals.shape[1] - 1)]
            szz = 0.5 * (3 * cosang(local_z, n2) ** 2 - 1)
            syy = 0.5 * (3 * cosang(local_y, n2) ** 2 - 1)
            syz = 1.5 * cosang(local_y, n2) * cosang(local_z, n2)
            if corr:
                order[:, i] = -(
                    np.cos(a2) ** 2 * syy
                    + np.sin(a2) ** 2 * szz
                    + 2 * np.cos(a2) * np.sin(a2) * syz
                )
            else:
                order[:, i] = -(szz / 4 + 3 * syy / 4 + np.sqrt(3.0) * syz / 2)
    return order


def lipid_tail_order(
    order_type: str,
    coords: np.ndarray,
    normals: np.ndarray,
    bond_orders: np.ndarray,
) -> np.ndarray:
    """Per-carbon tail order parameters for one lipid tail.

    ``order_type``: 'sz' (GROMACS -szonly), 'scd' (ideal-H deuterium order),
    'scdcorr' (double-bond-corrected H). ``coords``: (N,3) tail carbons in
    chain order; ``normals``: (1,3) global or (N-2,3) per-bond; ``bond_orders``
    (N-1,) of 1/2. Output: (N-2,) order values for carbons 1..N-2.
    """
    coords = np.asarray(coords, dtype=np.float64)
    normals = np.asarray(normals, dtype=np.float64).reshape(-1, 3)
    n = len(coords)
    if n < 3:
        raise MeasureError(f"lipid tail too short: {n} atoms")
    if len(normals) not in (1, n - 2):
        raise MeasureError(f"need 1 or {n - 2} normals, got {len(normals)}")
    if len(bond_orders) != n - 1:
        raise MeasureError(f"need {n - 1} bond orders, got {len(bond_orders)}")

    def nrm(k: int) -> np.ndarray:
        return normals[0] if len(normals) == 1 else normals[k]

    order = np.zeros(n - 2)
    if order_type == "sz":
        for at in range(1, n - 1):
            v = coords[at + 1] - coords[at - 1]
            ang = _angle(v, nrm(at - 1))
            order[at - 1] = 1.5 * np.cos(ang) ** 2 - 0.5
        return order

    if order_type not in ("scd", "scdcorr"):
        raise MeasureError(f"unknown order type {order_type!r}")
    corr = order_type == "scdcorr"
    for i in range(n - 2):
        if bond_orders[i] == 1:
            if bond_orders[i + 1] == 1:
                p1, p2, p3 = coords[i], coords[i + 1], coords[i + 2]
                local_z = _unit(p3 - p1)
                local_x = _unit(np.cross(p1 - p2, p3 - p2))
                local_y = np.cross(local_x, local_z)
                nv = nrm(i)
                sxx = 0.5 * (3 * np.cos(_angle(local_x, nv)) ** 2 - 1)
                syy = 0.5 * (3 * np.cos(_angle(local_y, nv)) ** 2 - 1)
                order[i] = -(2 * sxx + syy) / 3.0
        else:
            p1, p2, p3, p4 = coords[i - 1], coords[i], coords[i + 1], coords[i + 2]
            a1 = 0.5 * (np.pi - _angle(p1 - p2, p3 - p2))
            a2 = 0.5 * (np.pi - _angle(p2 - p3, p4 - p3))
            local_z = _unit(p3 - p2)
            local_x = _unit(np.cross(p1 - p2, local_z))
            local_y = np.cross(local_x, local_z)
            n1 = nrm(i)
            szz = 0.5 * (3 * np.cos(_angle(local_z, n1)) ** 2 - 1)
            syy = 0.5 * (3 * np.cos(_angle(local_y, n1)) ** 2 - 1)
            syz = 1.5 * np.cos(_angle(local_y, n1)) * np.cos(_angle(local_z, n1))
            if corr:
                order[i - 1] = -(
                    np.cos(a1) ** 2 * syy
                    + np.sin(a1) ** 2 * szz
                    - 2 * np.cos(a1) * np.sin(a1) * syz
                )
            else:
                order[i - 1] = -(szz / 4 + 3 * syy / 4 - np.sqrt(3.0) * syz / 2)
            local_x = _unit(np.cross(p3 - p4, local_z))
            local_y = np.cross(local_x, local_z)
            n2 = nrm(i + 1)
            szz = 0.5 * (3 * np.cos(_angle(local_z, n2)) ** 2 - 1)
            syy = 0.5 * (3 * np.cos(_angle(local_y, n2)) ** 2 - 1)
            syz = 1.5 * np.cos(_angle(local_y, n2)) * np.cos(_angle(local_z, n2))
            if corr:
                order[i] = -(
                    np.cos(a2) ** 2 * syy
                    + np.sin(a2) ** 2 * szz
                    + 2 * np.cos(a2) * np.sin(a2) * syz
                )
            else:
                order[i] = -(szz / 4 + 3 * syy / 4 + np.sqrt(3.0) * syz / 2)
    return order
