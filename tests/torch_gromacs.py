"""Minimal GROMACS files for the port's tests, written by walking the
readers of ``molar_tpu_torch/io/tpx.py`` backwards.

:func:`write_tpx` writes a single- or double-precision tpx file (default
v122, the layout ``read_tpx`` decodes): the header, the box, the symbol
table, force-field parameters for ``F_BONDS`` and ``F_SETTLE``, two
molecule types (a SETTLE water, and a molecule of ``F_BONDS`` bonds over
two residues), molecule blocks, the trailing groups, then coordinates and
velocities. :func:`write_cpt` writes a checkpoint in the entry layout
``read_cpt`` walks: header strings and scalars, then the box,
coordinates and velocities as ``<count><type><data>`` entries. Both
packages' decoders must read these files alike. Imports neither JAX nor
pytest.
"""

from __future__ import annotations

import struct

import numpy as np

# FTYPES_2020 indices (molar_tpu/io/tpx.py), every type present at v >= 121.
F_BONDS = 0
F_SETTLE = 64
N_FTYPES = 94
# Layout of the iparams of the two function types used here (reals only).
_N_REALS = {F_BONDS: 4, F_SETTLE: 2}


class _W:
    def __init__(self, precision: int):
        self.parts: list[bytes] = []
        self.precision = precision

    def i32(self, v):
        self.parts.append(struct.pack(">i", int(v)))

    def i64(self, v):
        self.parts.append(struct.pack(">q", int(v)))

    def f64(self, v):
        self.parts.append(struct.pack(">d", float(v)))

    def real(self, v):
        self.parts.append(struct.pack(">d" if self.precision == 8 else ">f", float(v)))

    def reals(self, a):
        dt = ">f8" if self.precision == 8 else ">f4"
        self.parts.append(np.asarray(a, np.float64).ravel().astype(dt).tobytes())

    def ints(self, a):
        self.parts.append(np.asarray(a, np.int64).ravel().astype(">i4").tobytes())

    def raw(self, b: bytes):
        self.parts.append(b)

    def xdr_string(self, s: str):
        b = s.encode()
        self.i32(len(b) + 1)
        self.i32(len(b))
        self.raw(b + b"\0" * ((len(b) + 3) // 4 * 4 - len(b)))

    def string64(self, s: str):
        b = s.encode()
        self.i64(len(b))
        self.raw(b)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


# name, type name, residue index, mass, charge, atomic number
WATER = [("OW", "OW", 0, 15.9994, -0.834, 8), ("HW1", "HW", 0, 1.008, 0.417, 1),
         ("HW2", "HW", 0, 1.008, 0.417, 1)]
LIGAND = [("C1", "CT", 0, 12.011, -0.18, 6), ("C2", "CT", 0, 12.011, 0.145, 6),
          ("O3", "OH", 1, 15.9994, -0.683, 8), ("H4", "HO", 1, 1.008, 0.418, 1),
          ("N5", "N3", 1, 14.007, 0.3, 7)]
LIGAND_BONDS = [(0, 1), (1, 2), (2, 3), (1, 4)]
LIGAND_RESIDUES = [("ETH", 7), ("OHN", 8)]


def molecule_counts(n_water: int):
    """(atoms, bonds) of :func:`write_tpx`'s topology: one ligand, then
    ``n_water`` waters."""
    return len(LIGAND) + 3 * n_water, len(LIGAND_BONDS) + 2 * n_water


def write_tpx(path, coords, velocities, box_rows, n_water: int, version: int = 122,
              precision: int = 4):
    """A tpx file of one ligand molecule (5 atoms in 2 residues, F_BONDS)
    then ``n_water`` SETTLE waters; ``coords`` / ``velocities`` (natoms, 3)
    nm and nm/ps, ``box_rows`` (3, 3) in GROMACS row order."""
    natoms = len(LIGAND) + 3 * n_water
    coords = np.asarray(coords).reshape(natoms, 3)
    w = _W(precision)
    w.xdr_string("VERSION 2021.4")
    w.i32(precision)
    w.i32(version)
    w.i32(28)  # file generation
    w.xdr_string("release")
    w.i32(natoms)
    w.i32(0)  # ngtc
    w.i32(0)  # fep state
    w.real(0.0)  # lambda
    for flag in (0, 1, 1, velocities is not None, 0, 1):  # ir, top, x, v, f, box
        w.i32(flag)
    w.i64(0)  # body size (not read)
    w.reals(box_rows)
    w.reals(np.zeros(9))  # box_rel
    w.reals(np.zeros(9))  # boxv

    symtab = ["system", "SOL", "LIG"]

    def sym(s):
        if s not in symtab:
            symtab.append(s)
        return symtab.index(s)

    moltypes = []
    for name, atoms, residues, bonds, settle in (
            ("LIG", LIGAND, LIGAND_RESIDUES, LIGAND_BONDS, False),
            ("SOL", WATER, [("SOL", 1)], [], True)):
        moltypes.append((sym(name), atoms, [(sym(rn), nr) for rn, nr in residues],
                         [(sym(a[0]), sym(a[1])) for a in atoms], bonds, settle))

    body = _W(precision)
    body.i32(len(symtab))
    for s in symtab:
        body.string64(s)
    body.i32(0)  # the topology's name
    # ffparams: two interaction types, F_BONDS (type 0) and F_SETTLE (type 1)
    body.i32(2)  # atnr
    body.i32(2)
    body.i32(F_BONDS)
    body.i32(F_SETTLE)
    body.f64(12.0)  # reppow
    body.real(0.8333)  # fudgeQQ
    body.reals([0.109, 284512.0, 0.109, 284512.0])
    body.reals([0.09572, 0.15139])
    body.i32(len(moltypes))
    rt = ">f8" if precision == 8 else ">f4"
    rec = np.dtype([("m", rt), ("q", rt), ("mB", rt), ("qB", rt), ("type", ">u2"),
                    ("typeB", ">u2"), ("ptype", ">i4"), ("resind", ">i4"), ("z", ">i4")])
    for name_idx, atoms, residues, names, bonds, settle in moltypes:
        body.i32(name_idx)
        body.i32(len(atoms))
        body.i32(len(residues))
        r = np.zeros(len(atoms), rec)
        r["m"] = r["mB"] = [a[3] for a in atoms]
        r["q"] = r["qB"] = [a[4] for a in atoms]
        r["type"] = r["typeB"] = np.arange(len(atoms)) % 2
        r["resind"] = [a[2] for a in atoms]
        r["z"] = [a[5] for a in atoms]
        body.raw(r.tobytes())
        body.ints([n for n, _ in names])
        body.ints([t for _, t in names])
        body.ints([t for _, t in names])  # typeB names
        for rn, nr in residues:
            body.i32(rn)
            body.i32(nr)
            body.raw(b" ")  # insertion code
        for ftype in range(N_FTYPES):
            if ftype == F_BONDS and bonds:
                iat = [v for a, b in bonds for v in (0, a, b)]
            elif ftype == F_SETTLE and settle:
                iat = [1, 0, 1, 2]
            else:
                iat = []
            body.i32(len(iat))
            body.ints(iat)
        body.i32(len(atoms))  # charge groups: one an atom
        body.ints(np.arange(len(atoms) + 1))
        body.i32(len(atoms))  # exclusions: none
        body.i32(0)
        body.ints(np.zeros(len(atoms) + 1))
    body.i32(2)  # molblocks: one ligand, then the waters
    for mtype, nmol in ((0, 1), (1, n_water)):
        body.i32(mtype)
        body.i32(nmol)
        body.i32(0)  # nposres
        body.i32(0)
        body.i32(0)
    body.i32(natoms)
    body.i32(0)  # no intermolecular interactions
    body.raw(struct.pack("<i", 2) + np.array([6, 8], "<i4").tobytes())
    body.raw(struct.pack("<i", 0))  # cmap grids
    for _ in range(10):
        body.i32(0)
    body.i32(0)
    for _ in range(10):
        body.i32(0)
    body.i64(0)  # intermolecular exclusion group
    body.reals(coords)
    if velocities is not None:
        body.reals(velocities)
    with open(path, "wb") as fh:
        fh.write(w.bytes() + body.bytes())


def write_cpt(path, coords, velocities, box_rows, step: int, time: float):
    """A checkpoint with the box, coordinates and (optionally) velocities
    as f32 entries; ``box_rows`` in GROMACS row order."""
    w = _W(4)

    def cpt_string(s):
        b = s.encode()
        w.i32(len(b))
        w.raw(b + b"\0" * ((len(b) + 3) // 4 * 4 - len(b)))

    coords = np.asarray(coords, np.float32)
    w.i32(171817)
    for s in ("2021.4", "today", "user", "host"):
        cpt_string(s)
    w.i32(18)  # file version
    w.i32(0)  # double precision flag
    cpt_string("label")
    w.i32(len(coords))
    for v in (0, 0, 0, 0, 0, 1):  # ngtc, nnhpres, nhchainlength, nlambda, integrator, part
        w.i32(v)
    w.i64(step)
    w.f64(time)
    w.i32(1)  # nnodes
    w.ints([1, 1, 1])
    for _ in range(8):  # npme, state / eks / enh / dfh flags, nED, swap, modular
        w.i32(0)
    entries = [np.asarray(box_rows, np.float32), coords]
    if velocities is not None:
        entries.append(np.asarray(velocities, np.float32))
    for a in entries:
        w.i32(a.size)
        w.i32(1)
        w.raw(a.astype(">f4").tobytes())
    with open(path, "wb") as fh:
        fh.write(w.bytes())
