"""Neighbour-search scenes shared by the port's tests and ``chip_smoke.py``.

Random scenes, exact cutoff ties (values exact in float32: an inclusive
cutoff keeps the tie, one ulp-scale step beyond it drops it), tiny and
collapsed periodic grids where several images of one cell are in range,
partial PBC, and a small solvated protein at the headline's density. They
rebuild the knife-edge cases of the JAX package's neighbour tests. Imports
neither JAX nor pytest, so the smoke can use them on the card.
"""

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
    if name == "solvated_protein":
        from molar_tpu_torch.headline import make_system

        side = 10.0 * (5000 / 100_000) ** (1 / 3)
        coords, _ = make_system(5000, 500, side)
        return coords, None, np.arange(500), 0.5, (side,) * 3, full, 64
    raise KeyError(name)


#: Every scene; each fits its cap (no overflow).
SCENES = ["random7", "random19", "tie_at_cutoff", "tie_across_boundary",
          "tiny_periodic_0.9_a", "tiny_periodic_0.9_b", "tiny_periodic_1.7",
          "tiny_periodic_2.6", "dim1_all", "dim1_x", "partial_pbc_TFT",
          "tiny_grid_1.7_0.4", "solvated_protein"]

#: Source indices the inclusive cutoff must keep in the tie scenes.
TIE_MEMBERS = {"tie_at_cutoff": [1, 3], "tie_across_boundary": [1]}
