"""Neighbour-search scenes shared by the port's tests and ``chip_smoke.py``.

Random scenes, exact cutoff ties (values exact in float32: an inclusive
cutoff keeps the tie, one ulp-scale step beyond it drops it), tiny and
collapsed periodic grids where several images of one cell are in range,
partial PBC, and a small solvated protein at the headline's density. They
rebuild the knife-edge cases of the JAX package's neighbour tests;
:func:`window` makes a window of frames of one, each in its own box, and
:func:`cell_members` / :func:`blocked_members` put cell contents in one
order for comparison. The row
scenes (:data:`ROW_SCENES`) are the orthorhombic full-PBC ones plus those of
the row kernel's own tests, one with a 2-cell axis. The dodecahedron scenes
fill rhombic dodecahedra at 100 atoms/nm^3, and :func:`brute_within` is
their float64 ground truth over the lattice images. Imports neither JAX nor
pytest, so the smoke can use them on the card.
"""

import os

import numpy as np

EPS = 2.0**-10


def scene(name):
    """``name`` -> (coords, src indices or None for all, tgt indices, cutoff,
    box side lengths, pbc, source cap)."""
    full = (True, True, True)
    if name.startswith("random"):
        seed, cutoff = {"random7": (7, 0.5), "random19": (19, 0.9)}[name]
        rng = np.random.default_rng(seed)
        coords = rng.uniform(-2, 8, (900, 3)).astype(np.float32)
        tgt = np.sort(rng.choice(900, 120, replace=False))
        return coords, None, tgt, cutoff, (4.0, 5.0, 6.0), full, 64
    if name == "tie_at_cutoff":
        coords = np.array([[1, 1, 1], [1.5, 1, 1], [1.5 + EPS, 1, 1], [1, 1.5, 1],
                           [1, 1, 1.5 + EPS]], np.float32)
        return coords, np.arange(1, 5), np.array([0]), 0.5, (4.0,) * 3, full, 8
    if name == "tie_across_boundary":
        coords = np.array([[3.75, 2, 2], [0.25, 2, 2], [0.25 + EPS, 2, 2]], np.float32)
        return coords, np.array([1, 2]), np.array([0]), 0.5, (4.0,) * 3, full, 8
    if name.startswith("tiny_periodic"):
        side, n, cutoff = {"tiny_periodic_0.9_a": (0.9, 40, 0.3),
                           "tiny_periodic_0.9_b": (0.9, 40, 0.45),
                           "tiny_periodic_1.7": (1.7, 80, 0.45),
                           "tiny_periodic_2.6": (2.6, 120, 0.3)}[name]
        rng = np.random.default_rng(int(side * 100))
        coords = rng.uniform(-side, 2 * side, (n, 3)).astype(np.float32)
        tgt = np.sort(rng.choice(n, max(n // 5, 3), replace=False))
        return coords, None, tgt, cutoff, (side,) * 3, full, n
    if name.startswith("dim1"):
        sides = {"dim1_all": (0.7, 0.7, 0.7), "dim1_x": (0.7, 2.0, 2.0)}[name]
        rng = np.random.default_rng(77)
        coords = (rng.uniform(-1, 2, (60, 3)) * np.asarray(sides)).astype(np.float32)
        tgt = np.sort(rng.choice(60, 12, replace=False))
        return coords, None, tgt, 0.4, sides, full, 60
    if name == "partial_pbc_TFT":
        rng = np.random.default_rng(4)
        coords = rng.uniform(-2, 8, (500, 3)).astype(np.float32)
        inside = np.flatnonzero((coords[:, 1] >= 0) & (coords[:, 1] < 5.0))
        return coords, inside, inside[::6], 0.5, (4.0, 5.0, 6.0), (True, False, True), 64
    if name == "tiny_grid_1.7_0.4":
        rng = np.random.default_rng(17)
        coords = rng.uniform(-1.7, 3.4, (400, 3)).astype(np.float32)
        tgt = np.sort(rng.choice(400, 80, replace=False))
        return coords, None, tgt, 0.4, (1.7, 1.87, 2.04), full, 400
    if name.startswith("pallas"):
        seed, cutoff = {"pallas11_0.5": (11, 0.5), "pallas3_0.8": (3, 0.8)}[name]
        rng = np.random.default_rng(seed)
        coords = rng.uniform(-2, 8, (700, 3)).astype(np.float32)
        tgt = np.sort(rng.choice(700, 90, replace=False))
        return coords, None, tgt, cutoff, (4.0, 5.0, 6.0), full, 48
    if name == "small_grid_2x4x4":
        rng = np.random.default_rng(5)
        coords = rng.uniform(0, 4, (200, 3)).astype(np.float32)
        return coords, None, np.arange(0, 200, 5), 0.9, (2.0, 4.0, 4.0), full, 128
    if name == "crowded":
        # 8,000 targets in every 27-cell neighbourhood (more than the ghost
        # stencil kernel stages at once) and ~300 sources a cell (more than
        # one pass of its threads).
        rng = np.random.default_rng(23)
        coords = rng.uniform(0, 3, (8000, 3)).astype(np.float32)
        return coords, None, np.arange(8000), 0.9, (3.0,) * 3, full, 400
    if name == "solvated_protein":
        from molar_tpu_torch.headline import make_system

        side = 10.0 * (5000 / 100_000) ** (1 / 3)
        coords, _ = make_system(5000, 500, np.diag([side] * 3))
        return coords, None, np.arange(500), 0.5, (side,) * 3, full, 64
    raise KeyError(name)


#: Every scene; each fits its cap (no overflow).
SCENES = ["random7", "random19", "tie_at_cutoff", "tie_across_boundary",
          "tiny_periodic_0.9_a", "tiny_periodic_0.9_b", "tiny_periodic_1.7",
          "tiny_periodic_2.6", "dim1_all", "dim1_x", "partial_pbc_TFT",
          "tiny_grid_1.7_0.4", "solvated_protein"]

#: The ghost kernels' scenes: every shared scene, and one that needs the
#: stencil kernel's chunked staging and several thread passes.
GHOST_SCENES = SCENES + ["crowded"]

#: Source indices the inclusive cutoff must keep in the tie scenes.
TIE_MEMBERS = {"tie_at_cutoff": [1, 3], "tie_across_boundary": [1]}

#: Scenes of the row-tiled min-image search (orthorhombic, full PBC).
ROW_SCENES = [n for n in SCENES if n != "partial_pbc_TFT"] + [
    "pallas11_0.5", "pallas3_0.8", "small_grid_2x4x4"]


def window(name, n_frames: int = 4, seed: int = 0):
    """A window of ``n_frames`` frames of scene ``name``: each frame its
    coordinates plus N(0, 0.05) noise, in its own box (sides scaled by
    U(0.97, 1.03) per axis; frame 0 keeps the scene's box) -> (coords (B, N,
    3) f32, src, tgt, cutoff, boxes (B, 3, 3) f32, invs, pbc, cap, dims).
    ``dims`` fits the smallest box of each axis; ``cap`` is the window's
    largest cell occupancy (sources or targets) plus 2, rounded up to 8."""
    coords, src, tgt, cutoff, sides, pbc, _ = scene(name)
    rng = np.random.default_rng(seed)
    scale = np.concatenate([np.ones((1, 3)), rng.uniform(0.97, 1.03, (n_frames - 1, 3))])
    sides = np.asarray(sides, np.float32) * scale.astype(np.float32)
    boxes = np.stack([np.diag(s) for s in sides]).astype(np.float32)
    invs = np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)
    frames = coords[None] + rng.normal(0, 0.05, (n_frames, *coords.shape)).astype(np.float32)
    frames[0] = coords
    dims = tuple(max(int(np.floor(float(s) / cutoff)), 1) for s in sides.min(axis=0))
    occupancy = 0
    for f in range(n_frames):
        cell = np.minimum((((frames[f] / sides[f]) % 1.0) * dims).astype(np.int64),
                          np.asarray(dims) - 1) @ np.array([dims[1] * dims[2], dims[2], 1])
        for idx in (np.arange(len(coords)) if src is None else src, tgt):
            occupancy = max(occupancy, np.bincount(cell[idx]).max())
    return frames, src, tgt, cutoff, boxes, invs, pbc, (occupancy + 2 + 7) // 8 * 8, dims


def cell_members(rec, counts, cap: int):
    """Each cell's members of cell records, in list-position order ->
    (positions (..., n_cells, cap) int64, -1 past the count; coordinates
    (..., n_cells, cap, 3), 0 past the count). ``rec`` (..., n_cells, cap, 4)
    with positions as int32 bits in the fourth lane; ``counts`` (...,
    n_cells)."""
    import torch

    valid = torch.arange(cap, device=rec.device) < counts.clamp(max=cap)[..., None]
    pos = rec[..., 3].contiguous().view(torch.int32).long()
    pos, order = torch.where(valid, pos, torch.iinfo(torch.int64).max).sort(dim=-1)
    xyz = torch.gather(rec[..., :3], -2, order[..., None].expand(*order.shape, 3))
    return torch.where(valid, pos, -1), torch.where(valid[..., None], xyz, 0.0)


def blocked_members(coords, src_idx, tgt_idx, box, inv, dims, cap: int, tgt_cap: int):
    """One frame's cell members by the plain plane build
    (``ops.neighbor._blocked_planes``, stable: list-position order) ->
    ((source positions, source coordinates), (target positions, target
    coordinates)) in :func:`cell_members`' layout."""
    import torch

    from molar_tpu_torch.ops.neighbor import _blocked_planes, _search_args

    nx, ny, nz = dims
    sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz = _search_args(coords, src_idx, tgt_idx, box,
                                                                 inv, dims)
    tflat = (tcx * ny + tcy) * nz + tcz
    out = []
    for pts, flat, k in (((sx, sy, sz), sflat, cap), ((tx, ty, tz), tflat, tgt_cap)):
        pos = torch.arange(pts[0].shape[0], device=coords.device)
        planes, *_ = _blocked_planes([*pts, pos], flat, nx * ny * nz, k, [0.0, 0.0, 0.0, -1])
        out.append((planes[3], torch.stack(planes[:3], -1)))
    return tuple(out)


def dodecahedron(d: float) -> np.ndarray:
    """Rhombic dodecahedron box matrix of image distance ``d`` (columns
    a = (d, 0, 0), b = (0, d, 0), c = (d/2, d/2, d*sqrt(2)/2)): the shape
    ``gmx editconf -bt dodecahedron`` gives, volume d^3 * sqrt(2)/2."""
    return np.array([[d, 0.0, d / 2], [0.0, d, d / 2], [0.0, 0.0, d * np.sqrt(2) / 2]],
                    dtype=np.float32)


def dodeca_scene(d: float, seed: int = 0, density: float = 100.0, tgt_every: int = 50):
    """Uniform atoms at ``density`` per nm^3 in the dodecahedron of image
    distance ``d`` (fractional coordinates uniform in [0, 1)), targets a
    random subset of one atom in ``tgt_every`` -> (coords f32, targets,
    box matrix)."""
    m = dodecahedron(d)
    n = int(round(density * abs(np.linalg.det(m.astype(np.float64)))))
    rng = np.random.default_rng(seed)
    coords = (rng.uniform(0, 1, (n, 3)) @ m.T.astype(np.float64)).astype(np.float32)
    tgt = np.sort(rng.choice(n, max(n // tgt_every, 1), replace=False))
    return coords, tgt, m


def brute_within(coords, src, tgt, matrix, cutoff: float, chunk: int = 64):
    """Float64 ground truth: for every source, the least distance to any
    target over the lattice images. The displacement is reduced to
    fractional [-0.5, 0.5] and then the 27 images i*a + j*b + k*c,
    (i, j, k) in {-1, 0, 1}^3, around it are all measured. Returns (mask
    ``dmin <= cutoff``, dmin)."""
    m = np.asarray(matrix, np.float64)
    inv = np.linalg.inv(m)
    c = np.asarray(coords, np.float64)
    s_pts, t_pts = c[np.asarray(src)], c[np.asarray(tgt)]
    shifts = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], np.float64) @ m.T
    dmin = np.empty(len(s_pts))
    for lo in range(0, len(s_pts), chunk):
        d = t_pts[None, :, :] - s_pts[lo: lo + chunk, None, :]
        f = d @ inv.T
        d = (f - np.round(f)) @ m.T
        best = np.full(d.shape[:2], np.inf)
        for sh in shifts:
            e = d + sh
            np.minimum(best, np.einsum("ijk,ijk->ij", e, e), out=best)
        dmin[lo: lo + chunk] = np.sqrt(best.min(axis=1))
    return dmin <= cutoff, dmin


# The bars of one membrane window's outputs against another's (the card
# against the CPU; the port against the JAX package): (rtol, atol) of each
# float output, compared on valid lipids only (an invalid lipid's area,
# curvatures, normal and order come from an ill-conditioned fit that nothing
# reads); ``thv`` on every lipid. Flags, counts and neighbour sets equal.
MEMBRANE_BARS = {"area": (1e-5, 1e-6), "normal": (1e-5, 1e-6), "thv": (1e-5, 1e-6),
                 "order": (1e-5, 1e-6), "mean_curv": (1e-4, 1e-5), "gauss_curv": (1e-4, 1e-5)}


def membrane_diffs(want, got, sp_lipids) -> dict:
    """Two membrane window outputs (numpy dicts) -> for each exact output
    the number of entries that differ (``nb_sets``: lipids whose neighbour
    id sets differ), for each float output the worst ``|got - want| / (atol
    + rtol |want|)`` (at most 1 within :data:`MEMBRANE_BARS`)."""
    out = {k: int((np.asarray(got[k]) != np.asarray(want[k])).sum())
           for k in ("valid", "overflow", "n_neighbors", "nb_mask")}
    gi, wi = np.asarray(got["nb_ids"]), np.asarray(want["nb_ids"])
    gm, wm = np.asarray(got["nb_mask"]), np.asarray(want["nb_mask"])
    out["nb_sets"] = sum(sorted(gi[f, i][gm[f, i]]) != sorted(wi[f, i][wm[f, i]])
                         for f in range(gi.shape[0]) for i in range(gi.shape[1]))
    v = np.asarray(want["valid"], bool)

    def ratio(g, w, key, keep):
        rtol, atol = MEMBRANE_BARS[key]
        g, w = np.asarray(g, np.float64)[keep], np.asarray(w, np.float64)[keep]
        return float((np.abs(g - w) / (atol + rtol * np.abs(w))).max(initial=0.0))

    for key in ("area", "mean_curv", "gauss_curv", "normal"):
        out[key] = ratio(got[key], want[key], key, v)
    out["thv"] = ratio(got["thv"], want["thv"], "thv", slice(None))
    out["order_tails"] = int({sp: len(t) for sp, t in got["order"].items()}
                             != {sp: len(t) for sp, t in want["order"].items()})
    out["order"] = max((ratio(g, w, "order", v[:, sp_lipids[sp]])
                        for sp in want["order"]
                        for g, w in zip(got["order"][sp], want["order"][sp])), default=0.0)
    return out


def membrane_within_bars(diffs: dict) -> bool:
    return all(v <= (1.0 if k in MEMBRANE_BARS else 0) for k, v in diffs.items())


# Selections of the device tier held on the card against the CPU
# (``tests/test_torch_kernels.py``) on :func:`selection_scene`: searches
# under full, partial and no PBC, of a point, with the self flag, and the
# math grammar.
SELECTION_TEXTS = [
    "name OW and within 0.5 pbc of protein",
    "within 0.5 pbc of protein",
    "resname SOL and 2.0 < z < 4.0",
    "within 1.0 pbc of [2.0, 2.0, 2.0]",
    "within 0.7 self of resid 3 or within 0.45 pbc yny of water",
    "within 0.6 of resname LIG or within 0.8 of 1.0 1.0 1.0",
    "protein and (x < 2.0 or not within 0.4 pbc self of resname LIG)",
    "x * 2 >= y and -x + 2 > 1 or x ^ 2 > 4.0 and vdw < 0.16 or x / 3 <= 0.5"
    " or sqrt(x^2 + y^2) < 2",
]


def selection_scene(kind: str = "box", n_frames: int = 4, seed: int = 0):
    """A small solvated system with a topology: 36 protein residues (ALA /
    GLY / LYS with realistic atom names) in chains A-C, 120 waters (SOL
    OW/HW1/HW2), 4 ligands (LIG), and a window of ``n_frames`` frames ->
    (topology, coords (B, N, 3) f32, boxes (B, 3, 3), invs). ``kind``
    "box": a 4 nm cube whose sides change by U(0.97, 1.03) a frame, every
    atom wrapped into its frame's box; "dodecahedron": a rhombic
    dodecahedron of image distance 4 nm, scaled by 1 +- 1% a frame."""
    from molar_tpu_torch.convert import topology_from_numpy
    from molar_tpu_torch.core import periodic_table as pt

    rng = np.random.default_rng(seed)
    names, resnames, resid, chain, centres = [], [], [], [], []
    kinds = [("ALA", ["N", "CA", "C", "O", "CB", "HB1"]), ("GLY", ["N", "CA", "C", "O", "HA2"]),
             ("LYS", ["N", "CA", "C", "O", "CB", "NZ", "HZ1"])]
    groups = [(ch, *kinds[rng.integers(3)], 0.15) for ch in "ABC" for _ in range(12)]
    groups += [("W", "SOL", ["OW", "HW1", "HW2"], 0.05)] * 120
    groups += [("L", "LIG", ["C1", "C2", "O1", "H1"], 0.1)] * 4
    for r, (ch, rn, nms, spread) in enumerate(groups):
        base = rng.uniform(0.2, 3.8, 3)
        for nm in nms:
            names.append(nm)
            resnames.append(rn)
            resid.append(r + 1)
            chain.append(ch)
            centres.append(base + rng.uniform(-spread, spread, 3))
    n = len(names)
    z = np.array([pt.guess_element_from_name(nm, rn) for nm, rn in zip(names, resnames)])
    resid = np.asarray(resid)
    top = topology_from_numpy(names, resnames, resid, resid - 1, chain,
                              [pt.mass_of(int(k)) for k in z], rng.uniform(-1, 1, n),
                              rng.uniform(0, 1, n), rng.uniform(0, 99, n), z)
    coords0 = np.asarray(centres, np.float64)
    noise = rng.normal(0, 0.05, (n_frames, n, 3))
    noise[0] = 0
    if kind == "box":
        scale = np.concatenate([np.ones((1, 3)), rng.uniform(0.97, 1.03, (n_frames - 1, 3))])
        sides = (4.0 * scale).astype(np.float32)
        coords = ((coords0 + noise) * scale[:, None, :]).astype(np.float32) % sides[:, None, :]
        boxes = np.stack([np.diag(s) for s in sides]).astype(np.float32)
    elif kind == "dodecahedron":
        scale = 1.0 + 0.01 * np.sin(np.arange(n_frames))
        boxes = (dodecahedron(4.0)[None] * scale[:, None, None]).astype(np.float32)
        coords = ((coords0 + noise) * scale[:, None, None]).astype(np.float32)
    else:
        raise KeyError(kind)
    invs = np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)
    return top, coords.astype(np.float32), boxes, invs


def membrane_group_diffs(want: dict, got: dict) -> dict:
    """Two membranes' group statistics (name -> ``LipidGroup``) -> for each
    key of ``workloads.MEMBRANE_TOL`` the worst ``|got - want| / (atol + rtol
    |want|)`` over every group and species (at most 1 within it): the mean
    area (``check_area``), mean curvature (``check_mean``) and order
    parameter (``check_order``, every tail and carbon)."""
    from molar_tpu_torch.workloads import MEMBRANE_TOL

    worst = dict.fromkeys(MEMBRANE_TOL, 0.0)
    assert set(want) == set(got)
    for name, gr in want.items():
        assert gr.species_names == got[name].species_names
        for sp in gr.species_names:
            a, b = gr.per_species[sp], got[name].per_species[sp]
            pairs = {"check_area": [(a["area"].mean, b["area"].mean)],
                     "check_mean": [(a["mean_curv"].mean, b["mean_curv"].mean)],
                     "check_order": [(x.mean, y.mean) for x, y in
                                     zip(a["order"] or [], b["order"] or [])]}
            for key, vals in pairs.items():
                rtol, atol = MEMBRANE_TOL[key]
                for w, g in vals:
                    w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
                    r = float((np.abs(g - w) / (atol + rtol * np.abs(w))).max(initial=0.0))
                    worst[key] = max(worst[key], r)
    return worst


def _membrane_file_values(path: str) -> dict:
    """``check_*`` key -> the values a membrane output file holds: the mean
    area and mean curvature of each species line of a ``stats_*.dat``, the
    mean order of each carbon line of an ``order_*.dat``."""
    out = {"check_area": [], "check_mean": [], "check_order": []}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.split()
            if os.path.basename(path).startswith("stats_"):
                out["check_area"].append(float(cols[2].split("±")[0]))
                out["check_mean"].append(float(cols[4].split("±")[0]))
            else:
                out["check_order"].append(float(cols[1]))
    return out


def membrane_file_diffs(want_dir: str, got_dir: str) -> dict:
    """Two membrane output directories (the same file names) -> for each
    key of ``workloads.MEMBRANE_TOL`` the worst ``|got - want| / (atol +
    rtol |want| + 5e-5)`` over the files' values (at most 1 within it; 5e-5
    is half the last printed digit)."""
    from molar_tpu_torch.workloads import MEMBRANE_TOL

    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)), (names, sorted(os.listdir(got_dir)))
    worst = dict.fromkeys(MEMBRANE_TOL, 0.0)
    for name in names:
        want = _membrane_file_values(os.path.join(want_dir, name))
        got = _membrane_file_values(os.path.join(got_dir, name))
        for key, (rtol, atol) in MEMBRANE_TOL.items():
            w, g = np.asarray(want[key]), np.asarray(got[key])
            assert w.shape == g.shape, (name, key)
            r = np.abs(g - w) / (atol + rtol * np.abs(w) + 5e-5)
            worst[key] = max(worst[key], float(r.max(initial=0.0)))
    return worst


EXAMPLE_MEMBRANE_TOML = """
sel = "all"
cutoff = 2.0
order_type = "scdcorr"
output_dir = "{out}"

[lipids.LIP]
whole = "resname LIP"
head = "name P"
mid = "name C1"
tails = ["C1-C2-C3-C4"]
"""


def example_inputs(d: str, n_frames: int = 6, bilayer_side: int = 4) -> dict:
    """Inputs of the port's six examples in directory ``d``, from seeds ->
    name -> path: a protein scene PDB (``scene_pdb``) and ``n_frames`` of it
    jittered by 0.002 nm as an XTC, a bilayer GRO / XTC / TOML, a TIP3 water
    box GRO and 2-hydroxyvaleric acid as an SDF."""
    from molar_tpu_torch import workloads as wl
    from molar_tpu_torch.convert import topology_from_numpy
    from molar_tpu_torch.core.atom import Atom
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.core.system import System
    from molar_tpu_torch.core.topology import Topology
    from molar_tpu_torch.io import FileHandler

    from torch_molecules import molecule_system, with_hydrogens
    from torch_structures import scene_pdb

    p = {k: os.path.join(d, v) for k, v in (
        ("pdb", "scene.pdb"), ("xtc", "scene.xtc"), ("bilayer_gro", "bilayer.gro"),
        ("bilayer_xtc", "bilayer.xtc"), ("toml", "membrane.toml"), ("tip3", "tip3.gro"),
        ("sdf", "ligand.sdf"), ("obj", "ses.obj"), ("tip4", "tip4.gro"),
        ("membrane_out", "membrane_out"))}
    with open(p["pdb"], "w") as fh:
        fh.write(scene_pdb(seed=2))
    system = System.from_file(p["pdb"])
    rng = np.random.default_rng(0)
    with FileHandler(p["xtc"], "w") as fh:
        for k in range(n_frames):
            st = system.state.copy()
            st.coords = (st.coords + rng.normal(0, 0.002, st.coords.shape)).astype(np.float32)
            st.time, st.step = float(k), k
            fh.write(system.topology, st)
    bilayer = wl.synth_bilayer(bilayer_side, bilayer_side)
    n = len(bilayer.coords)
    nl = n // 6
    top = topology_from_numpy(["P", "G", "C1", "C2", "C3", "C4"] * nl, ["LIP"] * n,
                              np.repeat(np.arange(1, nl + 1), 6), np.repeat(np.arange(nl), 6),
                              ["A"] * n, np.full(n, 12.0), np.zeros(n), np.ones(n), np.zeros(n),
                              np.full(n, 6))
    System(top, State(coords=bilayer.coords, box=PeriodicBox(bilayer.box))).save(
        p["bilayer_gro"])
    wl.write_membrane_xtc(bilayer, p["bilayer_xtc"], 3)
    with open(p["toml"], "w") as fh:
        fh.write(EXAMPLE_MEMBRANE_TOML.format(out=p["membrane_out"]))
    atoms, coords = [], []
    for k in range(2):
        atoms.append(Atom(name="CA", resname="ALA", resid=k + 1, atomic_number=6, mass=12.0))
        coords.append(rng.uniform(0, 3, 3))
    for w in range(3):
        base = rng.uniform(0, 3, 3)
        for name, z, off in (("OW", 8, [0, 0, 0]), ("HW1", 1, [0.0957, 0, 0]),
                             ("HW2", 1, [-0.024, 0.0927, 0])):
            atoms.append(Atom(name=name, resname="TIP3", resid=10 + w, atomic_number=z,
                              mass=float(z)))
            coords.append(base + off)
    wtop = Topology.from_atoms(atoms)
    wtop.assign_resindex()
    System(wtop, State(coords=np.asarray(coords, np.float32),
                       box=PeriodicBox(np.diag([3.0] * 3)))).save(p["tip3"])
    # 2-hydroxyvaleric acid (Kekule bonds only, as GAFF typing needs).
    heavy = with_hydrogens([6, 8, 8, 6, 8, 6, 6, 6], [(0, 1, 2), (0, 2, 1), (0, 3, 1),
                                                      (3, 4, 1), (3, 5, 1), (5, 6, 1),
                                                      (6, 7, 1)])
    molecule_system(*heavy, seed=2).save(p["sdf"])
    return p


def example_argv(p: dict) -> dict:
    """The command line of each example over :func:`example_inputs`' files."""
    return {
        "rmsd_trajectory": ["-f", p["pdb"], p["xtc"], "--sel", "name CA", "--window", "4",
                            "--log", "0"],
        "contacts": ["-f", p["pdb"], p["xtc"], "--target", "resname LIG", "--cutoff", "0.5",
                     "--window", "4", "--log", "0"],
        "structure_report": [p["pdb"], "--sel", "chain A", "--obj", p["obj"]],
        "membrane_curvature": ["-f", p["bilayer_gro"], p["bilayer_xtc"], "--options", p["toml"]],
        "tip3to4_tutorial": [p["tip3"], p["tip4"]],
        "assign_ff": [p["sdf"]],
    }


def water_box(n_side: int = 6, side: float = 1.86206, seed: int = 0):
    """A solvent box like GROMACS's ``spc216.gro``: ``n_side``^3 SOL waters
    (OW, HW1, HW2) on a jittered lattice in a cube of ``side`` nm, each
    water's hydrogens 0.1 nm from its oxygen at the tetrahedral angle, in a
    direction from ``default_rng(seed)`` -> a port ``System``."""
    from molar_tpu_torch.core.atom import Atom
    from molar_tpu_torch.core.pbc import PeriodicBox
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.core.system import System
    from molar_tpu_torch.core.topology import Topology

    rng = np.random.default_rng(seed)
    step = side / n_side
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    oxygens = (grid + 0.5) * step + rng.normal(0, 0.01, grid.shape)
    half = np.radians(109.47) / 2
    coords, atoms = [], []
    for k, o in enumerate(oxygens):
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        v = np.cross(u, rng.normal(size=3))
        v /= np.linalg.norm(v)
        for name, h in (("OW", o), ("HW1", o + 0.1 * (np.cos(half) * u + np.sin(half) * v)),
                        ("HW2", o + 0.1 * (np.cos(half) * u - np.sin(half) * v))):
            atoms.append(Atom(name=name, resname="SOL", resid=k + 1).guess_element_and_mass())
            coords.append(h)
    top = Topology.from_atoms(atoms)
    top.assign_resindex()
    return System(top, State(coords=np.asarray(coords, np.float32),
                             box=PeriodicBox(np.diag([side] * 3))))
