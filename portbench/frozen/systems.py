"""The benchmark's frozen generators of a configuration's system.

Copies, so that a later change to the program cannot move the benchmark's
inputs:

* :func:`make_system` is ``molar_tpu_torch/headline.py``'s ``make_system``
  (same draws in the same order);
* :func:`label` is ``headline.label_topology``'s naming, with the water and
  ion counts taken from the configuration instead of worked out;
* :func:`dodecahedron` is ``tests/torch_scenes.py``'s ``dodecahedron``;
* :data:`ELEMENTS` holds the masses and van der Waals radii of the elements
  these systems use, as ``molar_tpu_torch/core/periodic_table.py`` gives
  them, and :func:`element_of` the element that the port's name rule
  (``guess_element_from_name``) gives each of these names.
"""

from __future__ import annotations

import numpy as np

#: symbol -> (mass in amu, van der Waals radius in Angstrom).
ELEMENTS = {
    "H": (1.00794, 1.2),
    "C": (12.0107, 1.7),
    "N": (14.0067, 1.55),
    "O": (15.9994, 1.52),
    "Na": (22.989770, 1.36),
    "Cl": (35.453, 2.27),
}

# Residues the protein rows cycle through (``headline._PROTEIN_RESIDUES``).
PROTEIN_RESIDUES = (
    ("ALA", ("N", "H", "CA", "HA", "CB", "HB1", "HB2", "HB3", "C", "O")),
    ("GLY", ("N", "H", "CA", "HA1", "HA2", "C", "O")),
    ("SER", ("N", "H", "CA", "HA", "CB", "HB1", "HB2", "OG", "HG", "C", "O")),
)
_IONS = {"NA": "Na", "CL": "Cl"}


def box_matrix(box: dict) -> np.ndarray:
    """A configuration's box (columns are the box vectors, nm): ``{"shape":
    "orthorhombic", "sides_nm": [a, b, c]}`` or ``{"shape": "dodecahedron",
    "image_distance_nm": d}``."""
    if box["shape"] == "orthorhombic":
        return np.diag(np.asarray(box["sides_nm"], np.float64)).astype(np.float32)
    if box["shape"] == "dodecahedron":
        return dodecahedron(float(box["image_distance_nm"]))
    raise ValueError(f"unknown box shape {box['shape']!r}")


def dodecahedron(d: float) -> np.ndarray:
    """Rhombic dodecahedron of image distance ``d``: columns a = (d, 0, 0),
    b = (0, d, 0), c = (d/2, d/2, d*sqrt(2)/2), volume d^3 * sqrt(2)/2 (the
    shape ``gmx editconf -bt dodecahedron`` gives)."""
    return np.array([[d, 0.0, d / 2], [0.0, d, d / 2], [0.0, 0.0, d * np.sqrt(2) / 2]],
                    dtype=np.float32)


def make_system(n_atoms: int, n_protein: int, box, seed: int):
    """A uniform-density ball of ``n_protein`` atoms (indices
    ``0..n_protein-1``) at the box centre, at the box's mean density, and
    the solvent uniform over the rest of the box -> coords (n, 3) f32.

    The draws of ``headline.make_system`` in its order (solvent, then the
    ball), so the ball's rows are that function's; it then draws again,
    from the same generator, each solvent row that fell inside the ball,
    until none does (the program's copy leaves them there, at twice the
    density)."""
    m = np.asarray(box, dtype=np.float64)
    rng = np.random.default_rng(seed)
    water = (rng.uniform(0, 1, (n_atoms - n_protein, 3)) @ m.T).astype(np.float32)
    density = n_atoms / abs(np.linalg.det(m))
    radius = (3 * n_protein / (4 * np.pi * density)) ** (1 / 3)
    d = rng.normal(size=(n_protein, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius * rng.uniform(0, 1, (n_protein, 1)) ** (1 / 3)
    centre = m @ np.full(3, 0.5)
    protein = (centre + d * r).astype(np.float32)
    inside = np.linalg.norm(water - centre, axis=1) < radius
    while inside.any():
        water[inside] = (rng.uniform(0, 1, (int(inside.sum()), 3)) @ m.T).astype(np.float32)
        inside = np.linalg.norm(water - centre, axis=1) < radius
    return np.concatenate([protein, water])


def label(n_protein: int, n_water: int, ions) -> dict:
    """Names of the rows: ``n_protein`` protein atoms as ALA, GLY, SER in turn
    (the last residue cut where the rows end), ``n_water`` SOL waters (OW,
    HW1, HW2), then one residue an ion of ``ions`` (names) -> dict of
    ``names``, ``resnames``, ``resid`` (from 1, int64) and ``elements``."""
    names, resnames, resid = [], [], []
    r = 0
    while len(names) < n_protein:
        resname, atoms = PROTEIN_RESIDUES[r % len(PROTEIN_RESIDUES)]
        r += 1
        take = atoms[: n_protein - len(names)]
        names += take
        resnames += [resname] * len(take)
        resid += [r] * len(take)
    names += ["OW", "HW1", "HW2"] * n_water
    resnames += ["SOL"] * (3 * n_water)
    resid += [r + 1 + k // 3 for k in range(3 * n_water)]
    names += list(ions)
    resnames += list(ions)
    resid += [r + 1 + n_water + k for k in range(len(ions))]
    elements = [element_of(n, rn) for n, rn in zip(names, resnames)]
    return {"names": names, "resnames": resnames, "resid": np.asarray(resid, np.int64),
            "elements": elements}


def element_of(name: str, resname: str) -> str:
    """The element of one of :func:`label`'s names: an ion by its residue
    name, anything else by the first letter (a protein "CA" is a carbon)."""
    if name == resname and name in _IONS:
        return _IONS[name]
    return name[0]


def masses(elements) -> np.ndarray:
    return np.array([ELEMENTS[e][0] for e in elements], np.float32)


def vdw_nm(elements) -> np.ndarray:
    """Radii in nm as the port's table scales them (Angstrom x 0.1 in f32)."""
    a = np.array([ELEMENTS[e][1] for e in elements], np.float32)
    return (a * np.float32(0.1)).astype(np.float32)


def build(config: dict) -> dict:
    """A configuration's system: box, coordinates (from the configuration's
    own ``structure_seed``), labels, masses, and the protein's row indices.
    A run's seed moves the trajectory, not the structure, so that every seed
    gives the program the same cell occupancies and so the same work."""
    comp = config["composition"]
    ions = [name for name, count in comp["ions"] for _ in range(count)]
    # Alternating, as the program's labelling orders them (NA, CL, NA, ...).
    if len({name for name, _ in comp["ions"]}) > 1:
        order = [name for name, _ in comp["ions"]]
        counts = {name: count for name, count in comp["ions"]}
        ions, k = [], 0
        while sum(counts.values()):
            name = order[k % len(order)]
            k += 1
            if counts[name]:
                ions.append(name)
                counts[name] -= 1
    n = comp["protein_atoms"] + 3 * comp["waters"] + len(ions)
    if n != config["atoms"]:
        raise ValueError(f"composition adds up to {n} atoms, the configuration says "
                         f"{config['atoms']}")
    box = box_matrix(config["box"])
    labels = label(comp["protein_atoms"], comp["waters"], ions)
    return {
        "box": box,
        "coords": make_system(n, comp["protein_atoms"], box, int(config["structure_seed"])),
        "labels": labels,
        "masses": masses(labels["elements"]),
        "protein": np.arange(comp["protein_atoms"]),
    }


def write_gro(path, labels: dict, coords: np.ndarray, box: np.ndarray, title: str) -> None:
    """A GRO file of the rows (fixed columns, 3 decimals; an orthorhombic box
    as its three sides, any other as the nine numbers of the format)."""
    lines = [title, f"{len(coords):5d}"]
    fmt = "{:5d}{:<5s}{:>5s}{:5d}{:8.3f}{:8.3f}{:8.3f}".format
    for i, (name, resname, rid, (x, y, z)) in enumerate(
            zip(labels["names"], labels["resnames"], labels["resid"], coords)):
        lines.append(fmt(int(rid) % 100000, resname, name, (i + 1) % 100000, x, y, z))
    m = np.asarray(box, np.float64)
    if np.count_nonzero(m - np.diag(np.diag(m))) == 0:
        lines.append("{:10.5f}{:10.5f}{:10.5f}".format(*np.diag(m)))
    else:
        v = [m[0, 0], m[1, 1], m[2, 2], m[1, 0], m[2, 0], m[0, 1], m[2, 1], m[0, 2], m[1, 2]]
        lines.append("".join(f"{x:10.5f}" for x in v))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
