"""Synthetic structures for the port's ``System`` / IO / secondary-structure
tests and for ``chip_smoke.py``'s user-API phase (numpy only, no JAX).

* :func:`backbone` builds a protein backbone (N, CA, C, O a residue, nm) by
  NeRF from per-residue phi/psi: ideal alpha-helix, beta-strand and hairpin
  chains, with optional Gaussian noise on every atom;
* :func:`scene_pdb` writes a multi-chain PDB text: the chains, a water box
  and ligands whose CONECT records follow a TER (so the serials have gaps),
  with CRYST1 and the element column.
"""

from __future__ import annotations

import numpy as np

# Engh-Huber backbone geometry (Angstrom, degrees).
_N_CA, _CA_C, _C_N, _C_O = 1.458, 1.525, 1.329, 1.231
_N_CA_C, _CA_C_N, _C_N_CA, _CA_C_O = 111.2, 116.2, 121.7, 120.5

HELIX = (-57.0, -47.0)
STRAND = (-120.0, 130.0)


def _place(a, b, c, bond, angle, torsion):
    """The atom d with |cd| = ``bond``, angle bcd = ``angle`` and dihedral
    abcd = ``torsion`` (degrees)."""
    ang, tor = np.radians(angle), np.radians(torsion)
    bc = (c - b) / np.linalg.norm(c - b)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d = (-bond * np.cos(ang), bond * np.sin(ang) * np.cos(tor), bond * np.sin(ang) * np.sin(tor))
    return c + d[0] * bc + d[1] * m + d[2] * n


def backbone(phi_psi, noise: float = 0.0, seed: int = 0) -> np.ndarray:
    """(n_res * 4, 3) coordinates in nm of N, CA, C, O per residue, the
    residue k at ``phi_psi[k]`` (degrees), omega 180; ``noise`` adds
    N(0, noise) nm to every coordinate."""
    phi_psi = np.asarray(phi_psi, np.float64).reshape(-1, 2)
    n_res = len(phi_psi)
    bb = np.zeros((n_res, 3, 3))
    bb[0, 0] = (0.0, 0.0, 0.0)
    bb[0, 1] = (_N_CA, 0.0, 0.0)
    t = np.radians(180.0 - _N_CA_C)
    bb[0, 2] = bb[0, 1] + _CA_C * np.array([np.cos(t), np.sin(t), 0.0])
    for k in range(1, n_res):
        n0, ca0, c0 = bb[k - 1]
        n1 = _place(n0, ca0, c0, _C_N, _CA_C_N, phi_psi[k - 1, 1])
        ca1 = _place(ca0, c0, n1, _N_CA, _C_N_CA, 180.0)
        bb[k] = (n1, ca1, _place(c0, n1, ca1, _CA_C, _N_CA_C, phi_psi[k, 0]))
    out = np.zeros((n_res, 4, 3))
    out[:, :3] = bb
    for k in range(n_res):
        n0, ca0, c0 = bb[k]
        if k + 1 < n_res:
            out[k, 3] = _place(bb[k + 1, 0], ca0, c0, _C_O, _CA_C_O, 180.0)
        else:
            out[k, 3] = _place(n0, ca0, c0, _C_O, _CA_C_O, phi_psi[k, 1] + 180.0)
    xyz = out.reshape(-1, 3) * 0.1
    if noise:
        xyz = xyz + np.random.default_rng(seed).normal(0.0, noise, xyz.shape)
    return xyz


def hairpin(n_strand: int = 7) -> np.ndarray:
    """phi/psi of a beta-hairpin: a strand, a type I' turn, a strand."""
    return np.array([STRAND] * n_strand + [(60.0, 30.0), (90.0, 0.0)] + [STRAND] * n_strand)


CHAINS = {"helix": [HELIX] * 16, "strand": [STRAND] * 8, "hairpin": hairpin()}
RESNAMES = ("ALA", "LEU", "GLY", "SER", "LYS", "GLU")


def _atom_line(rec, serial, name, resname, chain, resid, xyz_nm, occ, beta, el):
    x, y, z = np.asarray(xyz_nm) * 10.0
    name = f" {name:<3s}" if len(name) < 4 else name[:4]
    return (f"{rec:<6s}{serial:5d} {name} {resname:<3s} {chain}{resid:4d}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}{occ:6.2f}{beta:6.2f}          {el:>2s}")


def scene_pdb(seed: int = 0, box=(4.0, 4.0, 4.0, 90.0, 90.0, 90.0), n_water: int = 40,
              n_ligand: int = 3, chains=("helix", "hairpin"), noise: float = 0.0) -> str:
    """PDB text of a scene in a ``box`` (lengths nm, angles degrees; None:
    no CRYST1): each of ``chains`` (keys of :data:`CHAINS`, or (n_res, 2)
    phi/psi arrays) as a backbone chain A, B, ... shifted into the box, ``n_water`` waters and
    ``n_ligand`` four-atom ligands with their CONECT records after the last
    TER, at seeded random places. Each TER takes a serial, so the serials
    have gaps."""
    rng = np.random.default_rng(seed)
    lines = []
    if box is not None:
        a, b, c, al, be, ga = box
        lines.append(f"CRYST1{a * 10:9.3f}{b * 10:9.3f}{c * 10:9.3f}{al:7.2f}{be:7.2f}{ga:7.2f}"
                     " P 1           1")
    side = min(box[:3]) if box is not None else 4.0
    serial = resid = 0
    for ci, key in enumerate(chains):
        xyz = backbone(CHAINS[key] if isinstance(key, str) else key, noise=noise, seed=seed + ci)
        xyz = xyz - xyz.mean(0) + rng.uniform(0.3 * side, 0.7 * side, 3)
        chain = "ABCDEFGH"[ci]
        for r in range(len(xyz) // 4):
            resid += 1
            resname = RESNAMES[rng.integers(len(RESNAMES))]
            for k, nm in enumerate(("N", "CA", "C", "O")):
                serial += 1
                lines.append(_atom_line("ATOM", serial, nm, resname, chain, resid, xyz[4 * r + k],
                                        1.0, float(rng.uniform(0, 50)), nm[0]))
        serial += 1
        lines.append(f"TER   {serial:5d}")
    for _ in range(n_water):
        resid += 1
        o = rng.uniform(0.1, side - 0.1, 3)
        for nm, el, off in (("OW", "O", 0.0), ("HW1", "H", 0.1), ("HW2", "H", -0.1)):
            serial += 1
            lines.append(_atom_line("ATOM", serial, nm, "SOL", "W", resid, o + off, 1.0, 0.0, el))
    conect = []
    for _ in range(n_ligand):
        resid += 1
        base = rng.uniform(0.5, side - 0.5, 3)
        first = serial + 1
        for k, (nm, el) in enumerate((("C1", "C"), ("C2", "C"), ("O1", "O"), ("N1", "N"))):
            serial += 1
            lines.append(_atom_line("HETATM", serial, nm, "LIG", "L", resid,
                                    base + 0.14 * np.array([k, k % 2, 0.0]), 0.5, 10.0, el))
        conect += [(first, first + 1), (first + 1, first + 2), (first + 1, first + 3)]
    lines.append("TER")
    for a, b in conect:
        lines.append(f"CONECT{a:5d}{b:5d}")
    lines.append("END")
    return "\n".join(lines) + "\n"
