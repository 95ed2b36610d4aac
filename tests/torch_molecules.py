"""Molecules for the espaloma charge model, shared by the port's tests and
``chip_smoke.py``.

:func:`ligand_corpus` draws drug-like molecules of 20-80 atoms with explicit
hydrogens from a seed: a ring core (benzene, pyridine, pyrrole, furan,
thiophene, naphthalene, indole, cyclohexane, cyclohexanone, piperidine)
grown by substituents and linked rings (alkyl, hydroxyl, ether, amine,
halogens, ketone, acid, amide, ester, nitrile, and charged groups:
carboxylate, ammonium, nitro with its formal charges). Aromatic rings are
written in a Kekule form and every atom's bond orders add up to its
valence. :func:`peptide` builds a chain of ALA / GLY / SER / PHE residues
from templates with their bond orders. A molecule is ``(z, fc, bonds)``:
atomic numbers, formal charges and ``(i, j, order)`` triples. Imports
neither JAX nor pytest, so the smoke can use it on the card.
"""

import numpy as np

# Valence of an element at a formal charge.
_VALENCE = {(1, 0): 1, (6, 0): 4, (7, 0): 3, (7, 1): 4, (8, 0): 2, (8, -1): 1,
            (9, 0): 1, (16, 0): 2, (17, 0): 1, (35, 0): 1}

# Ring cores: (atomic numbers, formal charges, bonds with Kekule orders).
RINGS = {
    "benzene": ([6] * 6, None, [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1), (4, 5, 2),
                                (5, 0, 1)]),
    "pyridine": ([7] + [6] * 5, None, [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1), (4, 5, 2),
                                       (5, 0, 1)]),
    "pyrrole": ([7] + [6] * 4, None, [(0, 1, 1), (1, 2, 2), (2, 3, 1), (3, 4, 2), (4, 0, 1)]),
    "furan": ([8] + [6] * 4, None, [(0, 1, 1), (1, 2, 2), (2, 3, 1), (3, 4, 2), (4, 0, 1)]),
    "thiophene": ([16] + [6] * 4, None, [(0, 1, 1), (1, 2, 2), (2, 3, 1), (3, 4, 2),
                                         (4, 0, 1)]),
    "naphthalene": ([6] * 10, None, [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1), (4, 9, 2),
                                     (9, 0, 1), (4, 5, 1), (5, 6, 2), (6, 7, 1), (7, 8, 2),
                                     (8, 9, 1)]),
    "indole": ([6] * 6 + [7, 6, 6], None, [(0, 1, 2), (1, 2, 1), (2, 3, 2), (3, 4, 1),
                                           (4, 5, 2), (5, 0, 1), (5, 6, 1), (6, 7, 1),
                                           (7, 8, 2), (8, 4, 1)]),
    "cyclohexane": ([6] * 6, None, [(k, (k + 1) % 6, 1) for k in range(6)]),
    "cyclohexanone": ([6] * 6 + [8], None, [(k, (k + 1) % 6, 1) for k in range(6)]
                      + [(0, 6, 2)]),
    "piperidine": ([7] + [6] * 5, None, [(k, (k + 1) % 6, 1) for k in range(6)]),
}

# Substituents, attached by their atom 0 through a single bond.
GROUPS = {
    "methyl": ([6], None, []),
    "ethyl": ([6, 6], None, [(0, 1, 1)]),
    "hydroxyl": ([8], None, []),
    "methoxy": ([8, 6], None, [(0, 1, 1)]),
    "amine": ([7], None, []),
    "fluoro": ([9], None, []),
    "chloro": ([17], None, []),
    "bromo": ([35], None, []),
    "ketone": ([6, 8, 6], None, [(0, 1, 2), (0, 2, 1)]),
    "aldehyde": ([6, 8], None, [(0, 1, 2)]),
    "acid": ([6, 8, 8], None, [(0, 1, 2), (0, 2, 1)]),
    "amide": ([6, 8, 7], None, [(0, 1, 2), (0, 2, 1)]),
    "ester": ([6, 8, 8, 6], None, [(0, 1, 2), (0, 2, 1), (2, 3, 1)]),
    "nitrile": ([6, 7], None, [(0, 1, 3)]),
    "thioether": ([16, 6], None, [(0, 1, 1)]),
    "carboxylate": ([6, 8, 8], [0, 0, -1], [(0, 1, 2), (0, 2, 1)]),
    "ammonium": ([7], [1], []),
    "nitro": ([7, 8, 8], [1, 0, -1], [(0, 1, 2), (0, 2, 1)]),
}
# Linkers between two rings: (atomic numbers, bonds, the atom the new ring
# bonds to); atom 0 bonds to the molecule. None: a direct bond.
LINKERS = {"bond": None, "methylene": ([6], [], 0), "ether": ([8], [], 0),
           "amine": ([7], [], 0), "ethylene": ([6, 6], [(0, 1, 1)], 1),
           "amide": ([6, 8, 7], [(0, 1, 2), (0, 2, 1)], 2)}


class _Mol:
    def __init__(self):
        self.z, self.fc, self.bonds = [], [], []

    def add(self, z, fc=None, bonds=()):
        """Append a fragment -> the index of its atom 0."""
        base = len(self.z)
        self.z += list(z)
        self.fc += list(fc) if fc is not None else [0] * len(z)
        self.bonds += [(base + i, base + j, o) for i, j, o in bonds]
        return base

    def free(self) -> np.ndarray:
        used = np.zeros(len(self.z), np.int64)
        for i, j, o in self.bonds:
            used[i] += o
            used[j] += o
        return np.array([_VALENCE[(z, f)] for z, f in zip(self.z, self.fc)]) - used

    def n_total(self) -> int:
        """Atoms once every free valence is a hydrogen."""
        return len(self.z) + int(self.free().sum())

    def site(self, rng):
        """A random heavy atom with a free valence, or None."""
        free = self.free()
        sites = np.flatnonzero(free > 0)
        return int(rng.choice(sites)) if len(sites) else None

    def finish(self):
        """Hydrogens on every free valence -> (z, fc, bonds)."""
        for a, k in enumerate(self.free()):
            for _ in range(k):
                self.bonds.append((a, len(self.z), 1))
                self.z.append(1)
                self.fc.append(0)
        assert not self.free().any()
        return (np.array(self.z, np.int64), np.array(self.fc, np.int64), list(self.bonds))


def with_hydrogens(z, bonds, fc=None):
    """A heavy-atom graph with a hydrogen on every free valence -> (z, fc,
    bonds)."""
    m = _Mol()
    m.add(z, fc, bonds)
    return m.finish()


def ligand(rng, core: str, n_target: int):
    """One molecule grown from ``core`` until it has about ``n_target``
    atoms (hydrogens included) -> (z, fc, bonds), or None when a draw
    overshoots 80 atoms or stays under 20."""
    m = _Mol()
    m.add(*RINGS[core])
    for _ in range(40):
        if m.n_total() >= n_target:
            break
        at = m.site(rng)
        if at is None:
            break
        if rng.random() < 0.25:
            name = list(RINGS)[rng.integers(len(RINGS))]
            linker = LINKERS[list(LINKERS)[rng.integers(len(LINKERS))]]
            if linker is not None:
                lz, lb, tail = linker
                head = m.add(lz, None, lb)
                m.bonds.append((at, head, 1))
                at = head + tail
            ring = m.add(*RINGS[name])
            free = m.free()
            anchors = [ring + k for k in range(len(RINGS[name][0])) if free[ring + k] > 0]
            if not anchors:
                return None
            m.bonds.append((at, int(rng.choice(anchors)), 1))
        else:
            name = list(GROUPS)[rng.integers(len(GROUPS))]
            m.bonds.append((at, m.add(*GROUPS[name]), 1))
        if (m.free() < 0).any():
            return None
    n = m.n_total()
    return m.finish() if 20 <= n <= 80 else None


def ligand_corpus(n: int, seed: int = 0) -> list:
    """``n`` molecules of 20-80 atoms from ``default_rng(seed)``; the k-th
    grows from the core ``list(RINGS)[k % len(RINGS)]``, so every core is
    in a corpus of ten or more. The first molecules of a corpus do not
    depend on its length."""
    rng = np.random.default_rng(seed)
    cores = list(RINGS)
    out = []
    while len(out) < n:
        mol = ligand(rng, cores[len(out) % len(cores)], int(rng.integers(20, 81)))
        if mol is not None:
            out.append(mol)
    return out


# Residue templates: heavy atoms (name, z), bonds with orders; N, CA, C, O
# first. Hydrogens fill the free valences.
_RESIDUES = {
    "GLY": ([("N", 7), ("CA", 6), ("C", 6), ("O", 8)], [(0, 1, 1), (1, 2, 1), (2, 3, 2)]),
    "ALA": ([("N", 7), ("CA", 6), ("C", 6), ("O", 8), ("CB", 6)],
            [(0, 1, 1), (1, 2, 1), (2, 3, 2), (1, 4, 1)]),
    "SER": ([("N", 7), ("CA", 6), ("C", 6), ("O", 8), ("CB", 6), ("OG", 8)],
            [(0, 1, 1), (1, 2, 1), (2, 3, 2), (1, 4, 1), (4, 5, 1)]),
    "PHE": ([("N", 7), ("CA", 6), ("C", 6), ("O", 8), ("CB", 6), ("CG", 6), ("CD1", 6),
             ("CD2", 6), ("CE1", 6), ("CE2", 6), ("CZ", 6)],
            [(0, 1, 1), (1, 2, 1), (2, 3, 2), (1, 4, 1), (4, 5, 1), (5, 6, 2), (6, 8, 1),
             (8, 10, 2), (10, 9, 1), (9, 7, 2), (7, 5, 1)]),
}
PEPTIDE_CYCLE = ("ALA", "GLY", "SER", "PHE")


def peptide(n_res: int):
    """A chain of ``n_res`` residues cycling ALA, GLY, SER, PHE, peptide
    bonds C(i)-N(i+1), a neutral amine N terminus and an acid C terminus
    (OXT), hydrogens on every free valence -> (z, fc, bonds)."""
    m = _Mol()
    prev_c = None
    for k in range(n_res):
        atoms, bonds = _RESIDUES[PEPTIDE_CYCLE[k % len(PEPTIDE_CYCLE)]]
        base = m.add([z for _, z in atoms], None, bonds)
        if prev_c is not None:
            m.bonds.append((prev_c, base, 1))
        prev_c = base + 2
    m.bonds.append((prev_c, m.add([8]), 1))
    return m.finish()


def molecule_system(z, fc, bonds, seed: int = 0):
    """A port ``System`` of one molecule ``(z, fc, bonds)``: atoms named by
    their element, residue ``MOL`` 1, bond orders and formal charges set,
    coordinates drawn from ``default_rng(seed)`` in a 1 nm cube (a file
    format and the typing read the connection table only)."""
    from molar_tpu_torch.convert import topology_from_numpy
    from molar_tpu_torch.core import periodic_table as pt
    from molar_tpu_torch.core.state import State
    from molar_tpu_torch.core.system import System

    z = np.asarray(z)
    n = len(z)
    top = topology_from_numpy(
        [pt.element_symbol(int(v)) for v in z], ["MOL"] * n, np.ones(n), np.zeros(n),
        ["A"] * n, pt.ELEMENT_MASSES[z], np.zeros(n), np.zeros(n), np.zeros(n), z,
        [(i, j) for i, j, _ in bonds], [o for *_, o in bonds],
        formal_charge=np.zeros(n, np.int8) if fc is None else np.asarray(fc))
    coords = np.random.default_rng(seed).uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return System(top, State(coords=coords))
