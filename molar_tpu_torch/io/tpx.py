"""Native GROMACS TPR (tpx) reader — no libgromacs required.

The port's own copy of ``molar_tpu.io.tpx`` (no JAX).

The reference reads ``.tpr`` through a C++ wrapper linked against an
installed GROMACS (molar_gromacs/gromacs/wrapper.cpp; our ctypes analog is
``io/tpr.py`` + ``native/gromacs_plugin.cpp``). That requires libgromacs on
the machine. This module decodes the tpx container DIRECTLY — XDR
(big-endian) primitives, the 2020/2021-era body layout — so real ``.tpr``
files open without any GROMACS installation.

Extraction surface mirrors the reference wrapper (wrapper.cpp:44-110,
161-200): per-atom name/type/resname/resid/mass/charge/atomic number, bonds
from the bonded/constraint interaction lists (F_BONDS, F_G96BONDS,
F_HARMONIC, F_FENEBONDS, F_CUBICBONDS, F_CONSTR, F_CONSTRNC, SETTLE as two
O-H bonds), plus box / coordinates / velocities.

Scope: tpx fileVersion >= 119 (tpxv_AddSizeField era — first written by
GROMACS 2020; the committed fixture is v122) through the 2023-era layout,
single- and double-precision files. The floor is the *verified* range: body
strings below v119 use a different (32-bit-length) serialization and the
pre-119 enum layouts are unimplemented, so older files raise a TpxError
naming the version and the supported range instead of risking a silent
misparse; they fall back to the plugin path. The interaction-function table
below must cover every function type that appears in the file's
``functype[]``; unknown types raise with the offending id rather than
silently misaligning the stream.

Format references: GROMACS public sources (src/gromacs/fileio/tpxio.cpp,
src/gromacs/topology/idef.h), re-derived; no GROMACS code is copied.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


class TpxError(RuntimeError):
    pass


# Oldest tpx fileVersion the native decoder accepts. v119 introduced the
# body-size field (tpxv_AddSizeField) and is the first version whose body
# strings use the 64-bit-length InMemorySerializer form this decoder
# implements; it is what GROMACS 2020 writes. Older files raise a TpxError
# pointing at the plugin path rather than risking a misaligned parse.
MIN_TPX_VERSION = 119


class Xdr:
    """Big-endian XDR primitive reader over one in-memory buffer."""

    def __init__(self, data: bytes, precision: int = 4):
        self.d = data
        self.o = 0
        self.precision = precision

    def i32(self) -> int:
        v = struct.unpack_from(">i", self.d, self.o)[0]
        self.o += 4
        return v

    def u32(self) -> int:
        v = struct.unpack_from(">I", self.d, self.o)[0]
        self.o += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from(">q", self.d, self.o)[0]
        self.o += 8
        return v

    def f32(self) -> float:
        v = struct.unpack_from(">f", self.d, self.o)[0]
        self.o += 4
        return v

    def f64(self) -> float:
        v = struct.unpack_from(">d", self.d, self.o)[0]
        self.o += 8
        return v

    def real(self) -> float:
        return self.f64() if self.precision == 8 else self.f32()

    def reals(self, n: int) -> np.ndarray:
        w = 8 if self.precision == 8 else 4
        dt = ">f8" if self.precision == 8 else ">f4"
        out = np.frombuffer(self.d, dtype=dt, count=n, offset=self.o)
        self.o += w * n
        return out.astype(np.float64)

    def ints(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.d, dtype=">i4", count=n, offset=self.o)
        self.o += 4 * n
        return out.astype(np.int64)

    def uchars(self, n: int) -> np.ndarray:
        # XDR encodes each unsigned char as a 4-byte word.
        return self.ints(n).astype(np.uint8)

    def string(self) -> str:
        # Legacy XDR string (HEADER only): i32 buffer size (len+1), then
        # xdr opaque: i32 len, len bytes padded to a 4-byte boundary.
        self.i32()
        ln = self.i32()
        s = self.d[self.o : self.o + ln]
        self.o += (ln + 3) // 4 * 4
        return s.decode("ascii", errors="replace")

    def string64(self) -> str:
        # tpx >= 119 BODY string (InMemorySerializer): u64 length + raw
        # bytes, no padding.
        ln = struct.unpack_from(">q", self.d, self.o)[0]
        if not (0 <= ln < 1 << 20):
            raise TpxError(f"implausible body string length {ln} @ {self.o}")
        self.o += 8
        s = self.d[self.o : self.o + ln]
        self.o += ln
        return s.decode("ascii", errors="replace")

    def skip(self, nbytes: int) -> None:
        self.o += nbytes


# --------------------------------------------------------------------------
# Interaction function table (GROMACS 2020/2021-era enum order, idef.h).
# Value = (#reals, #ints, layout) where layout encodes the do_iparams read
# order when ints and reals interleave: 'r'/'i' chars in stream order.
# Only types that can appear in ffparams.functype need entries; energy/
# bookkeeping types (F_EPOT..) never appear there but ARE present in the
# per-moltype ilist array, which is read generically (length-prefixed).
# --------------------------------------------------------------------------

FTYPES_2020 = [
    # (name, n_bonded_atoms, iparams layout)
    ("BONDS", 2, "rrrr"),
    ("G96BONDS", 2, "rrrr"),
    ("MORSE", 2, "rrrrrr"),
    ("CUBICBONDS", 2, "rrr"),
    ("CONNBONDS", 2, ""),
    ("HARMONIC", 2, "rrrr"),
    ("FENEBONDS", 2, "rr"),
    ("TABBONDS", 2, "rir"),
    ("TABBONDSNC", 2, "rir"),
    ("RESTRAINTPOT", 2, "rrrrrrrr"),
    ("ANGLES", 3, "rrrr"),
    ("G96ANGLES", 3, "rrrr"),
    ("RESTRANGLES", 3, "rr"),
    ("LINEAR_ANGLES", 3, "rrrr"),
    ("CROSS_BOND_BONDS", 3, "rrr"),
    ("CROSS_BOND_ANGLES", 3, "rrrr"),
    ("UREY_BRADLEY", 3, "rrrrrrrr"),
    ("QUARTIC_ANGLES", 3, "rrrrrr"),
    ("TABANGLES", 3, "rir"),
    ("PDIHS", 4, "rrrri"),
    ("RBDIHS", 4, "rrrrrrrrrrrr"),
    ("RESTRDIHS", 4, "rr"),
    ("CBTDIHS", 4, "rrrrrr"),
    ("FOURDIHS", 4, "rrrrrrrrrrrr"),
    ("IDIHS", 4, "rrrr"),
    ("PIDIHS", 4, "rrrri"),
    ("TABDIHS", 4, "rir"),
    ("CMAP", 5, "ii"),
    ("GB12", 2, ""),
    ("GB13", 2, ""),
    ("GB14", 2, ""),
    ("GBPOL", 0, ""),
    ("NPSOLVATION", 0, ""),
    ("LJ14", 2, "rrrr"),
    ("COUL14", 2, ""),
    ("LJC14_Q", 2, "rrrrr"),
    ("LJC_PAIRS_NB", 2, "rrrr"),
    ("LJ", 0, "rr"),
    ("BHAM", 0, "rrr"),
    ("LJ_LR", 0, ""),
    ("BHAM_LR", 0, ""),
    ("DISPCORR", 0, ""),
    ("COUL_SR", 0, ""),
    ("COUL_LR", 0, ""),
    ("RF_EXCL", 0, ""),
    ("COUL_RECIP", 0, ""),
    ("LJ_RECIP", 0, ""),
    ("DPD", 0, ""),
    ("POLARIZATION", 2, "r"),
    ("WATER_POL", 5, "rrrrrr"),
    ("THOLE_POL", 4, "rrrr"),
    ("ANHARM_POL", 2, "rrr"),
    ("POSRES", 1, "rrrrrrrrrrrr"),
    ("FBPOSRES", 1, "irrrrr"),
    ("DISRES", 2, "iirrrr"),
    ("DISRESVIOL", 0, ""),
    ("ORIRES", 2, "iiirrr"),
    ("ORIRESDEV", 0, ""),
    ("ANGRES", 4, "rrrri"),
    ("ANGRESZ", 2, "rrrri"),
    ("DIHRES", 4, "rrrrrr"),
    ("DIHRESVIOL", 0, ""),
    ("CONSTR", 2, "rr"),
    ("CONSTRNC", 2, "rr"),
    ("SETTLE", 3, "rr"),
    ("VSITE1", 1, ""),  # tpxv_VSite1 (2020+)
    ("VSITE2", 3, "r"),
    ("VSITE2FD", 3, "r"),
    ("VSITE3", 4, "rr"),
    ("VSITE3FD", 4, "rr"),
    ("VSITE3FAD", 4, "rr"),
    ("VSITE3OUT", 4, "rrr"),
    ("VSITE4FD", 5, "rrr"),
    ("VSITE4FDN", 5, "rrr"),
    ("VSITEN", 2, "ir"),
    ("COM_PULL", 0, ""),
    ("DENSITYFITTING", 0, ""),
    ("EQM", 0, ""),
    ("EPOT", 0, ""),
    ("EKIN", 0, ""),
    ("ETOT", 0, ""),
    ("ECONSERVED", 0, ""),
    ("TEMP", 0, ""),
    ("VTEMP", 0, ""),
    ("PDISPCORR", 0, ""),
    ("PRES", 0, ""),
    ("DVDL_CONSTR", 0, ""),
    ("DVDL", 0, ""),
    ("DKDL", 0, ""),
    ("DVDL_COUL", 0, ""),
    ("DVDL_VDW", 0, ""),
    ("DVDL_BONDED", 0, ""),
    ("DVDL_RESTRAINT", 0, ""),
    ("DVDL_TEMPERATURE", 0, ""),
]

F_BY_NAME = {name: i for i, (name, _, _) in enumerate(FTYPES_2020)}
N_FTYPES = len(FTYPES_2020)

# Bond-yielding interaction lists (wrapper.cpp:84-110 contract).
BOND_FTYPES = [
    F_BY_NAME[n]
    for n in (
        "BONDS",
        "G96BONDS",
        "HARMONIC",
        "FENEBONDS",
        "CUBICBONDS",
        "CONSTR",
        "CONSTRNC",
    )
]
F_SETTLE = F_BY_NAME["SETTLE"]


@dataclass
class TpxHeader:
    precision: int
    file_version: int
    file_generation: int
    natoms: int
    ngtc: int
    has_box: bool
    has_top: bool
    has_x: bool
    has_v: bool
    has_f: bool
    has_ir: bool


@dataclass
class TpxMoltype:
    name: str = ""
    natoms: int = 0
    nres: int = 0
    masses: np.ndarray = None
    charges: np.ndarray = None
    atomnumbers: np.ndarray = None
    resinds: np.ndarray = None
    atom_names: list = field(default_factory=list)
    type_names: list = field(default_factory=list)
    res_names: list = field(default_factory=list)
    res_nrs: np.ndarray = None
    bonds: list = field(default_factory=list)


@dataclass
class TpxTop:
    name: str = ""
    moltypes: list = field(default_factory=list)
    molblocks: list = field(default_factory=list)  # (moltype index, nmol)
    natoms: int = 0


def _read_header(x: Xdr) -> TpxHeader:
    x.string()  # "VERSION ..."
    precision = x.i32()
    if precision not in (4, 8):
        raise TpxError(f"bad tpx precision {precision}")
    x.precision = precision
    file_version = x.i32()
    if file_version < MIN_TPX_VERSION:
        # The floor is the empirically-verified serialization era: body
        # strings here use the 64-bit-length form introduced alongside
        # tpxv_AddSizeField (v119, first written by GROMACS 2020); older
        # files use 32-bit string headers and pre-119 enum layouts that
        # this decoder does not implement — accepting them would risk a
        # silently misaligned parse rather than this loud error.
        raise TpxError(
            f"tpx fileVersion {file_version} is older than the supported "
            f"range (>= {MIN_TPX_VERSION}, i.e. files written by GROMACS "
            "2020 or later); re-write the file with a modern `gmx convert-tpr`"
            " or use the GROMACS plugin path (molar_tpu_torch.io.tpr)"
        )
    file_generation = x.i32()
    x.string()  # file tag ("release")
    natoms = x.i32()
    ngtc = x.i32()
    x.i32()  # fep_state
    x.real()  # lambda
    has_ir = bool(x.i32())
    has_top = bool(x.i32())
    has_x = bool(x.i32())
    has_v = bool(x.i32())
    has_f = bool(x.i32())
    has_box = bool(x.i32())
    if file_version >= 119:  # tpxv_AddSizeField
        x.i64()  # body size (used for forward-compat skipping)
    return TpxHeader(
        precision,
        file_version,
        file_generation,
        natoms,
        ngtc,
        has_box,
        has_top,
        has_x,
        has_v,
        has_f,
        has_ir,
    )


def _ftype_present(name: str, file_version: int) -> bool:
    """Whether a function type exists in a file of this tpx version (the
    on-disk enum skips types introduced later, shifting every subsequent
    id). Gates shared by the ffparams id remap and the ilist walk."""
    if name == "VSITE1":
        return file_version >= 121  # tpxv_VSite1 (the only gate that can
        # fire inside the accepted >= MIN_TPX_VERSION range)
    if name == "VSITE2FD":
        return file_version >= 114  # tpxv_VSite2FD (always true at >= 119;
        # kept so the table documents the public tpxio.cpp constant)
    if name == "DENSITYFITTING":
        return file_version >= 117  # likewise always true at >= 119
    return True


def _ftype_id_map(file_version: int) -> list:
    """disk functype id -> FTYPES_2020 index for this file version."""
    return [
        i
        for i, (name, _, _) in enumerate(FTYPES_2020)
        if _ftype_present(name, file_version)
    ]


def _read_symtab(x: Xdr) -> list:
    n = x.i32()
    return [x.string64() for _ in range(n)]


def _read_iparams(x: Xdr, ftype: int, file_version: int) -> None:
    if ftype >= N_FTYPES:
        raise TpxError(f"function type {ftype} out of table range")
    name, _, layout = FTYPES_2020[ftype]
    if name in ("GB12", "GB13", "GB14", "GBPOL", "NPSOLVATION"):
        raise TpxError(
            f"obsolete GB function type {name} in a v{file_version} file"
        )
    for ch in layout:
        if ch == "r":
            x.real()
        else:
            x.i32()


def _read_ffparams(x: Xdr, file_version: int) -> list:
    x.i32()  # atnr
    ntypes = x.i32()
    if not (0 <= ntypes < 10_000_000):
        raise TpxError(f"implausible ffparams ntypes {ntypes}")
    idmap = _ftype_id_map(file_version)
    raw = [x.i32() for _ in range(ntypes)]
    try:
        functype = [idmap[ft] for ft in raw]
    except IndexError:
        raise TpxError(f"functype id out of range for tpx v{file_version}")
    x.f64()  # reppow (double regardless of precision)
    x.real()  # fudgeQQ
    for ft in functype:
        _read_iparams(x, ft, file_version)
    return functype


def _read_le_ints(x: Xdr) -> np.ndarray:
    """A little-endian i32 count + values array (the per-atomtype atomic
    number list after the mtop natoms field is serialized this way in v122
    files — empirically verified; the rest of the body is big-endian)."""
    cnt = struct.unpack_from("<i", x.d, x.o)[0]
    if not (0 <= cnt < 1_000_000):
        raise TpxError(f"implausible LE array count {cnt}")
    x.o += 4
    out = np.frombuffer(x.d, "<i4", count=cnt, offset=x.o).astype(np.int64)
    x.o += 4 * cnt
    return out


def _read_cmap(x: Xdr) -> None:
    # v122 layout (empirical): LE i32 ngrid, then a single-byte grid
    # spacing, then ngrid contiguous 4*spacing^2 big-endian real grids.
    ngrid = struct.unpack_from("<i", x.d, x.o)[0]
    if not (0 <= ngrid < 100_000):
        raise TpxError(f"implausible cmap ngrid {ngrid}")
    x.o += 4
    if ngrid:
        spacing = x.d[x.o]
        x.o += 1
        x.reals(ngrid * 4 * spacing * spacing)


def _read_ilists(x: Xdr, file_version: int) -> dict:
    out = {}
    for ftype in range(N_FTYPES):
        name = FTYPES_2020[ftype][0]
        if not _ftype_present(name, file_version):
            continue
        nr = x.i32()
        if not (0 <= nr < 100_000_000):
            raise TpxError(f"implausible ilist length {nr} for {name}")
        iat = x.ints(nr)
        if nr:
            out[ftype] = iat
    return out


def _read_block(x: Xdr) -> None:
    nr = x.i32()
    x.ints(nr + 1)


def _read_blocka(x: Xdr) -> None:
    nr = x.i32()
    nra = x.i32()
    x.ints(nr + 1)
    x.ints(nra)


def _read_atoms(x: Xdr, symtab: list, mt: TpxMoltype, file_version: int) -> None:
    nr = x.i32()
    nres = x.i32()
    mt.natoms = nr
    mt.nres = nres
    # t_atom record (body serializer, native field widths, big-endian):
    # m, q, mB, qB (reals), type/typeB (u16 each), ptype (i32),
    # resind (i32), atomnumber (i32).
    rt = ">f8" if x.precision == 8 else ">f4"
    dt = np.dtype(
        [
            ("m", rt),
            ("q", rt),
            ("mB", rt),
            ("qB", rt),
            ("type", ">u2"),
            ("typeB", ">u2"),
            ("ptype", ">i4"),
            ("resind", ">i4"),
            ("z", ">i4"),
        ]
    )
    rec = np.frombuffer(x.d, dtype=dt, count=nr, offset=x.o)
    x.o += dt.itemsize * nr
    mt.masses = rec["m"].astype(np.float64)
    mt.charges = rec["q"].astype(np.float64)
    mt.resinds = rec["resind"].astype(np.int64)
    mt.atomnumbers = rec["z"].astype(np.int64)
    name_idx = x.ints(nr)
    type_idx = x.ints(nr)
    x.ints(nr)  # typeB names
    mt.atom_names = [symtab[i] for i in name_idx]
    mt.type_names = [symtab[i] for i in type_idx]
    res_names = []
    res_nrs = np.empty(nres, np.int64)
    for r in range(nres):
        res_names.append(symtab[x.i32()])
        res_nrs[r] = x.i32()
        x.skip(1)  # insertion code (1 byte in the body serializer)
    mt.res_names = res_names
    mt.res_nrs = res_nrs


def _read_moltype(x: Xdr, symtab: list, file_version: int) -> TpxMoltype:
    mt = TpxMoltype()
    mt.name = symtab[x.i32()]
    _read_atoms(x, symtab, mt, file_version)
    ilists = _read_ilists(x, file_version)
    bonds = []
    for ftype, iat in ilists.items():
        width = 1 + FTYPES_2020[ftype][1]
        if ftype in BOND_FTYPES:
            t = iat.reshape(-1, width)
            bonds.extend(zip(t[:, 1].tolist(), t[:, 2].tolist()))
        elif ftype == F_SETTLE:
            t = iat.reshape(-1, width)
            for _, o, h1, h2 in t.tolist():
                bonds.append((o, h1))
                bonds.append((o, h2))
    mt.bonds = bonds
    _read_block(x)  # charge groups (one per atom in modern files)
    _read_blocka(x)  # exclusions
    return mt


def _read_molblock(x: Xdr) -> tuple:
    # type, nmol, nposres (outer), then the posres xA and xB vectors — each
    # vector carries its OWN element count (empirically verified layout of
    # the v122 body serializer; xB has no outer count).
    mtype = x.i32()
    nmol = x.i32()
    x.i32()  # nposres_xA (outer)
    ca = x.i32()
    if not (0 <= ca < 100_000_000):
        raise TpxError(f"implausible posres xA count {ca}")
    x.reals(3 * ca)
    cb = x.i32()
    if not (0 <= cb < 100_000_000):
        raise TpxError(f"implausible posres xB count {cb}")
    x.reals(3 * cb)
    return mtype, nmol


def _read_groups(x: Xdr, symtab: list, natoms: int) -> None:
    # AtomGroups: 10 index groups, group names, per-atom group numbers.
    egc_nr = 10
    for _ in range(egc_nr):
        nr = x.i32()
        x.ints(nr)
    ngrpname = x.i32()
    [x.i32() for _ in range(ngrpname)]
    for _ in range(egc_nr):
        nr = x.i32()
        if nr:
            x.uchars(nr)


def read_tpx(path: str):
    """Parse a .tpr file. Returns (header, TpxTop, box (3,3) float64 or
    None, coords (natoms, 3) or None, velocities or None) — units nm/ps,
    box COLUMNS are box vectors (transposed from GROMACS row convention)."""
    with open(path, "rb") as fh:
        data = fh.read()
    x = Xdr(data)
    h = _read_header(x)

    box = None
    if h.has_box:
        box = x.reals(9).reshape(3, 3)
        x.reals(9)  # box_rel
        x.reals(9)  # boxv
    if h.ngtc > 0:
        x.reals(h.ngtc)

    top = TpxTop()
    if h.has_top:
        symtab = _read_symtab(x)
        top.name = symtab[x.i32()]
        _read_ffparams(x, h.file_version)
        nmoltype = x.i32()
        if not (0 < nmoltype < 1_000_000):
            raise TpxError(f"implausible moltype count {nmoltype}")
        for _ in range(nmoltype):
            top.moltypes.append(_read_moltype(x, symtab, h.file_version))
        nmolblock = x.i32()
        for _ in range(nmolblock):
            top.molblocks.append(_read_molblock(x))
        top.natoms = x.i32()
        if top.natoms != h.natoms:
            raise TpxError(
                f"mtop natoms {top.natoms} != header natoms {h.natoms} "
                "(misaligned parse)"
            )
        if bool(x.i32()):  # intermolecular bonded interactions
            _read_ilists(x, h.file_version)
        _read_le_ints(x)  # per-atomtype atomic numbers
        _read_cmap(x)
        _read_groups(x, symtab, h.natoms)
        # intermolecularExclusionGroup: u64 element count + i32 elements.
        n_iex = struct.unpack_from(">q", x.d, x.o)[0]
        if not (0 <= n_iex <= h.natoms):
            raise TpxError(f"implausible exclusion-group count {n_iex}")
        x.o += 8
        x.ints(n_iex)

    coords = vels = None
    if h.has_x:
        coords = x.reals(3 * h.natoms).reshape(-1, 3)
    if h.has_v:
        vels = x.reals(3 * h.natoms).reshape(-1, 3)

    if box is not None:
        box = box.T  # rows (GROMACS) -> columns (the package's convention)
    return h, top, box, coords, vels


def read_cpt(path: str):
    """Native GROMACS checkpoint (.cpt) decode — box, coordinates,
    velocities, step, time. No libgromacs required.

    The cpt container is XDR: header strings/scalars, then the state as a
    sequence of self-describing entries ``<i32 count><i32 elemtype><data>``
    (elemtype 1 = f32, 2 = f64, 0 = i32). Which entries exist is governed
    by the header's ``state_flags`` bitfield; rather than reproduce the
    full flag enum across cpt versions, the reader walks entries
    structurally: the first 9-real entry is the box (row-major; transposed
    to column convention) and the first two ``3*natoms``-real entries are
    positions then velocities — the invariant layout of every version that
    stores them. Verified against GROMACS 2024-era files
    (tests fixture state.cpt, 96027 atoms).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    x = Xdr(data)
    magic = x.i32()
    if magic != 171817:
        raise TpxError(f"not a GROMACS checkpoint (magic {magic})")

    def cpt_string():
        ln = x.i32()
        if not (0 <= ln < 1 << 16):
            raise TpxError(f"implausible cpt string length {ln}")
        s = x.d[x.o : x.o + ln]
        x.o += (ln + 3) // 4 * 4
        return s.decode("ascii", errors="replace")

    cpt_string()  # gmx version
    cpt_string()  # btime
    cpt_string()  # buser
    cpt_string()  # bhost
    file_version = x.i32()
    if file_version < 16:
        raise TpxError(f"cpt version {file_version} too old for native read")
    # Modern layout (empirically: version, btime, buser, bhost came first,
    # then fprog/ftime strings precede the version int in some builds).
    # Rewind-free approach: the previous int may actually be a string
    # length; detect and re-read.
    if 0 < file_version < 1 << 16 and x.o + file_version <= len(x.d):
        # Heuristic: a printable run of that length means it was a string
        # (fprog); consume it and the following ftime string, then the
        # real version int.
        frag = x.d[x.o : x.o + min(file_version, 64)]
        if frag and all(32 <= c < 127 for c in frag):
            x.o += (file_version + 3) // 4 * 4  # fprog payload
            cpt_string()  # ftime
            file_version = x.i32()
    x.i32()  # double precision flag
    cpt_string()  # build host / label string
    natoms = x.i32()
    ngtc = x.i32()
    nnhpres = x.i32()
    nhchainlength = x.i32()
    x.i32()  # nlambda
    x.i32()  # integrator
    x.i32()  # simulation part
    step = x.i64()
    t = x.f64()
    x.i32()  # nnodes
    x.ints(3)  # dd_nc
    x.i32()  # npme
    x.i32()  # state flags
    x.i32()  # flags_eks
    x.i32()  # flags_enh
    x.i32()  # flags_dfh
    x.i32()  # nED
    x.i32()  # eSwapCoords
    if file_version >= 17:
        x.i32()  # modular simulator flag

    sizes = {0: 4, 1: 4, 2: 8}
    box = coords = vels = None
    want = 3 * natoms
    # Thermostat chains can legitimately exceed the coordinate bound on
    # tiny systems; allow for them in the plausibility window.
    bound = max(3 * natoms + 16, 2 * max(ngtc, 1) * max(nhchainlength, 1) + 16)
    for _ in range(4096):
        if x.o + 8 > len(x.d):
            break
        nval = x.i32()
        etype = x.i32()
        if etype not in sizes or not (0 <= nval <= bound):
            if coords is not None:
                # Past the state vectors (ekin/energy-history/file sections
                # are not <count,type>-framed): a coordinates-only
                # checkpoint (e.g. after energy minimization) ends here.
                break
            raise TpxError(
                f"unrecognized cpt entry (n={nval}, type={etype}) at "
                f"{x.o - 8}"
            )
        if etype == 2:
            arr = np.frombuffer(x.d, ">f8", count=nval, offset=x.o)
            x.o += 8 * nval
        elif etype == 1:
            arr = np.frombuffer(x.d, ">f4", count=nval, offset=x.o)
            x.o += 4 * nval
        else:
            arr = np.frombuffer(x.d, ">i4", count=nval, offset=x.o)
            x.o += 4 * nval
        if nval == 9 and etype in (1, 2) and box is None:
            box = arr.astype(np.float64).reshape(3, 3)
        elif nval == want and etype in (1, 2):
            if coords is None:
                coords = arr.astype(np.float64).reshape(-1, 3)
            elif vels is None:
                vels = arr.astype(np.float64).reshape(-1, 3)
                break
    if coords is None:
        raise TpxError("checkpoint contains no coordinate entry")
    if box is not None:
        box = box.T
    return natoms, step, t, box, coords, vels


class CptNativeHandler:
    """FormatHandler-shaped adapter over :func:`read_cpt` (state only)."""

    can_read_state = True

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise TpxError("cpt files are read-only")
        self.path = path
        with open(path, "rb") as fh:
            head = fh.read(4)
        if len(head) < 4 or struct.unpack(">i", head)[0] != 171817:
            raise TpxError(f"not a GROMACS checkpoint: {path}")
        self._read_any = False

    def close(self) -> None:
        pass

    def read_state(self):
        from ..config import NP_FLOAT as FLOAT
        from ..core.pbc import PeriodicBox, PeriodicBoxError
        from ..core.state import State

        if self._read_any:
            return None
        natoms, step, t, box, coords, vels = read_cpt(self.path)
        pbox = None
        if box is not None and np.any(box):
            try:
                pbox = PeriodicBox(box.astype(np.float32))
            except PeriodicBoxError:
                pbox = None
        st = State(coords=np.asarray(coords, FLOAT), box=pbox, time=float(t))
        if vels is not None:
            st.velocities = np.asarray(vels, FLOAT)
        self._read_any = True
        return st

    def iter_states(self):
        st = self.read_state()
        if st is not None:
            yield st


class TpxNativeHandler:
    """FormatHandler-shaped adapter over :func:`read_tpx`.

    Produces the same (Topology, State) surface as the libgromacs-backed
    ``TprHandler`` (io/tpr.py), which transparently falls back to this
    reader when no GROMACS installation is available. Single "frame".
    """

    can_read_topology = True
    can_read_state = True

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise TpxError("tpr files are read-only")
        self.path = path
        # Validate the header eagerly so unsupported/garbage files fail at
        # open time (the plugin fallback in io/tpr.py relies on this to
        # decide whether the native path can take over).
        with open(path, "rb") as fh:
            head = fh.read(4096)
        try:
            _read_header(Xdr(head))
        except (struct.error, IndexError, ValueError) as e:
            raise TpxError(f"not a readable tpx file: {path} ({e})")
        self._read_any = False
        self._stored_topology = None
        self._stored_state = None

    def close(self) -> None:
        pass

    def read(self):
        from ..config import NP_FLOAT as FLOAT
        from ..core.atom import Atom
        from ..core.pbc import PeriodicBox, PeriodicBoxError
        from ..core.state import State
        from ..core.topology import Topology

        if self._read_any:
            raise EOFError("tpr is single-frame")
        h, top, box, coords, vels = read_tpx(self.path)

        atoms: list = []
        bonds: list = []
        molecules: list = []
        resindex = 0
        offset = 0
        for mtype, nmol in top.molblocks:
            mt = top.moltypes[mtype]
            proto = [
                Atom(
                    name=mt.atom_names[i],
                    resname=mt.res_names[mt.resinds[i]],
                    resid=int(mt.res_nrs[mt.resinds[i]]),
                    atomic_number=int(mt.atomnumbers[i])
                    if mt.atomnumbers[i] > 0
                    else 0,
                    mass=float(mt.masses[i]),
                    charge=float(mt.charges[i]),
                    type_name=mt.type_names[i],
                )
                for i in range(mt.natoms)
            ]
            for _ in range(nmol):
                for i, a in enumerate(proto):
                    b = Atom(**{
                        "name": a.name, "resname": a.resname,
                        "resid": a.resid, "atomic_number": a.atomic_number,
                        "mass": a.mass, "charge": a.charge,
                        "type_name": a.type_name,
                        # Per-INSTANCE residue runs: repeated single-residue
                        # molecules (waters, ions) share a resid, and a
                        # run-boundary reassignment would merge them.
                        "resindex": resindex + int(mt.resinds[i]),
                    })
                    atoms.append(b)
                bonds.extend(
                    (offset + i, offset + j) for i, j in mt.bonds
                )
                molecules.append((offset, offset + mt.natoms - 1))
                resindex += mt.nres
                offset += mt.natoms

        topo = Topology.from_atoms(atoms)
        if bonds:
            topo.set_bonds(sorted({(min(i, j), max(i, j)) for i, j in bonds}))
        topo.molecules = np.asarray(molecules, dtype=np.int64)

        pbox = None
        if box is not None and np.any(box):
            try:
                pbox = PeriodicBox(box.astype(np.float32))
            except PeriodicBoxError:
                pbox = None
        st = State(
            coords=np.asarray(coords, FLOAT) if coords is not None
            else np.zeros((h.natoms, 3), FLOAT),
            box=pbox,
        )
        if vels is not None:
            st.velocities = np.asarray(vels, FLOAT)
        self._read_any = True
        return topo, st

    def read_topology(self):
        if self._stored_topology is not None:
            t, self._stored_topology = self._stored_topology, None
            return t
        top, st = self.read()
        self._stored_state = st
        return top

    def read_state(self):
        if self._stored_state is not None:
            s, self._stored_state = self._stored_state, None
            return s
        try:
            top, st = self.read()
        except EOFError:
            return None
        self._stored_topology = top
        return st

    def iter_states(self):
        st = self.read_state()
        if st is not None:
            yield st
