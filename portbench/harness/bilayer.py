"""A seeded all-atom CHARMM36 POPC bilayer, built in numpy from bond lengths,
angles and torsions (no program code).

Each POPC (C42H82NO8P, 134 atoms) carries CHARMM36's heavy-atom names in
CHARMM-GUI's order: the choline and phosphate, the glycerol (C1, C2, C3),
the sn-2 oleoyl chain C21-C218 with its cis C29=C210 double bond, and the
sn-1 palmitoyl chain C31-C316. Hydrogens are named as CHARMM36 names them
as far as that is known (every one but H91 and H101 is assumed); only P,
C2 and the tail carbons enter the membrane analysis.

A lipid is built in its own frame (the phosphorus at the origin, +z out of
the membrane): the head group and the glycerol from fixed positions, each
chain as a zigzag (0.153 nm bonds, 111 degree angles, the double bond 0.134
nm and 125 degrees) grown by torsions, trans with seeded noise, seeded
gauche kinks (g+ t g-, more often towards the chain's end) and the cis
torsion at the double bond (which turns the oleoyl chain's lower half away
from the palmitoyl chain). Every lipid is
then turned about its axis, tilted, and stood on a leaflet of an undulating
sheet: two leaflets of ``side`` x ``side`` jittered lattice sites, the
midplane a seeded height field of the lowest Fourier modes.
"""

from __future__ import annotations

import numpy as np

#: Masses (amu) by element, for the reference's mass-weighted markers.
MASSES = {"H": 1.00794, "C": 12.0107, "N": 14.0067, "O": 15.9994, "P": 30.973762}

_CH2 = ("R", "S")  # sn-2 CH2 hydrogens are HnR / HnS
_CH2_SN1 = ("X", "Y")  # sn-1 CH2 hydrogens are HnX / HnY


def _tail_names(prefix: str, first: int, last: int, hyd: tuple, end: str, double=()):
    """Names of a chain's carbons ``<prefix><first>`` .. ``<prefix><last>``
    each followed by its hydrogens: two on a CH2, three on the terminal
    carbon, one on a carbon of ``double``."""
    out = []
    for k in range(first, last + 1):
        out.append(f"C{prefix}{k}")
        if k in double:
            out.append(f"H{k}1")
        elif k == last:
            out += [f"H{k}{hyd[0]}", f"H{k}{hyd[1]}", f"H{k}{end}"]
        else:
            out += [f"H{k}{hyd[0]}", f"H{k}{hyd[1]}"]
    return out


#: The 134 atom names of one POPC, in order.
NAMES = (
    ["N", "C12", "H12A", "H12B", "C13", "H13A", "H13B", "H13C", "C14", "H14A", "H14B", "H14C",
     "C15", "H15A", "H15B", "H15C", "C11", "H11A", "H11B", "P", "O13", "O14", "O12", "O11",
     "C1", "HA", "HB", "C2", "HS", "O21", "C21", "O22", "C22", "H2R", "H2S", "C3", "HX", "HY",
     "O31", "C31", "O32", "C32", "H2X", "H2Y"]
    + _tail_names("2", 3, 18, _CH2, "T", double=(9, 10))
    + _tail_names("3", 3, 16, _CH2_SN1, "Z")
)
assert len(NAMES) == 134 and len(set(NAMES)) == 134

#: The two tails as the membrane TOML names them (carbons from C22 / C32).
SN2_CARBONS = [f"C2{k}" for k in range(2, 19)]
SN1_CARBONS = [f"C3{k}" for k in range(2, 17)]


def tail_string(carbons, double=()) -> str:
    """``C22-C23-...`` with ``=`` after each carbon named in ``double``."""
    return "".join(c + ("" if k == len(carbons) - 1 else "=" if c in double else "-")
                   for k, c in enumerate(carbons))


SN2_TAIL = tail_string(SN2_CARBONS, double=("C29",))
SN1_TAIL = tail_string(SN1_CARBONS)


def element(name: str) -> str:
    return name[0]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _place(a, b, c, bond, angle_deg, torsion_deg):
    """Natural extension: the atom bonded to ``c`` at ``bond`` nm, at angle
    ``angle_deg`` (b, c, new) and torsion ``torsion_deg`` (a, b, c, new);
    arrays broadcast over the leading axes."""
    bc = _unit(c - b)
    n = _unit(np.cross(b - a, bc))
    m = np.cross(n, bc)
    th = np.radians(angle_deg)
    ph = np.radians(np.asarray(torsion_deg, np.float64))[..., None]
    return c - bond * np.cos(th) * bc + bond * np.sin(th) * (np.cos(ph) * m + np.sin(ph) * n)


def _zigzag(base, k: int, across: int = 0):
    """Atom ``k`` of an all-trans chain along -z from ``base``, zigzagging
    along axis ``across`` (0: x, 1: y): 0.153 nm bonds at 111 degrees
    (0.1261 nm along the chain, 0.0866 across)."""
    step = np.zeros(3)
    step[across] = 0.0433 * (1 if k % 2 == 0 else -1)
    return np.asarray(base) + step + [0.0, 0.0, -0.1261 * k]


#: Heavy atoms of the head group and glycerol in the lipid's frame (nm); the
#: sn-1 chain continues the zigzag O31-C31-C32 (across x), the sn-2 chain
#: that of C21-C22-C23 (across y), 0.53 nm to the side.
_HEAVY = {"P": np.zeros(3)}
_HEAVY["C2"] = np.array([0.10, 0.05, -0.40])
_HEAVY["C1"] = _HEAVY["C2"] + [-0.05, -0.10, 0.10]
_HEAVY["O11"] = _HEAVY["C1"] + [0.0, 0.04, 0.14]
_HEAVY["O12"] = np.array([0.06, 0.08, 0.11])
_HEAVY["O13"] = np.array([-0.12, 0.08, -0.03])
_HEAVY["O14"] = np.array([0.02, -0.14, -0.03])
_HEAVY["C11"] = _HEAVY["O12"] + [0.10, 0.06, 0.08]
_HEAVY["C12"] = _HEAVY["C11"] + [0.12, 0.0, 0.09]
_HEAVY["N"] = _HEAVY["C12"] + [0.13, 0.05, 0.05]
_HEAVY["C3"] = _HEAVY["C2"] + [0.153, 0.0, 0.0]
_HEAVY["O31"] = _HEAVY["C3"] + [0.14, 0.0, -0.03]
_SN1_BASE = _HEAVY["O31"] - [0.0433, 0.0, 0.0]
_HEAVY["C31"] = _zigzag(_SN1_BASE, 1)
_HEAVY["O32"] = _HEAVY["C31"] + [-0.12, 0.0, 0.02]
_HEAVY["C32"] = _zigzag(_SN1_BASE, 2)
_HEAVY["O21"] = _HEAVY["C2"] + [-0.143, 0.0, 0.0]
_HEAVY["C21"] = _HEAVY["O21"] + [-0.14, 0.0, 0.0]
_HEAVY["O22"] = _HEAVY["C21"] + [-0.06, 0.0, 0.107]
_SN2_BASE = _HEAVY["C21"] - [0.0, 0.0433, 0.0]
_HEAVY["C22"] = _zigzag(_SN2_BASE, 1, across=1)
for _k, _name in enumerate(("C13", "C14", "C15")):
    _axis = _unit(_HEAVY["N"] - _HEAVY["C12"])
    _p1 = _unit(np.cross(_axis, [0.0, 0.0, 1.0]))
    _p2 = np.cross(_axis, _p1)
    _ph = np.radians(120.0 * _k)
    _HEAVY[_name] = _HEAVY["N"] + 0.149 * (np.cos(np.radians(70.5)) * _axis + np.sin(
        np.radians(70.5)) * (np.cos(_ph) * _p1 + np.sin(_ph) * _p2))


def _torsions(rng, n_lipids: int, n_atoms: int, kink_from: int, p_kink: float,
              noise_deg: float):
    """Placement torsions of a chain's atoms 3.. (n_lipids, n_atoms - 3):
    trans with seeded noise, and in a share ``p_kink`` of the chains a
    g+ t g- kink starting at an atom drawn from ``kink_from`` on, weighted
    towards the chain's end."""
    tors = 180.0 + rng.normal(0.0, noise_deg, (n_lipids, n_atoms - 3))
    starts = np.arange(kink_from, n_atoms - 2)
    w = (starts - kink_from + 1.0) ** 2
    at = rng.choice(starts, size=n_lipids, p=w / w.sum())
    sign = rng.choice([-1.0, 1.0], size=n_lipids)
    kinked = rng.uniform(size=n_lipids) < p_kink
    rows = np.flatnonzero(kinked)
    tors[rows, at[rows] - 3] = 180.0 + sign[rows] * 120.0
    tors[rows, at[rows] - 1] = 180.0 - sign[rows] * 120.0
    return tors


def _chains(rng, n_lipids: int):
    """Carbons of both chains of every lipid in its frame: sn-1 (C31..C316)
    and sn-2 (C21..C218), each (n_lipids, n, 3)."""
    # sn-1: O31, C31, C32 seed the growth of C33..C316 (16 backbone atoms after O31).
    n1 = 2 + 15  # O31, C31, C32..C316
    sn1 = np.zeros((n_lipids, n1, 3))
    sn1[:, 0], sn1[:, 1], sn1[:, 2] = _HEAVY["O31"], _HEAVY["C31"], _HEAVY["C32"]
    t1 = _torsions(rng, n_lipids, n1, kink_from=4, p_kink=0.6, noise_deg=8.0)
    for k in range(3, n1):
        sn1[:, k] = _place(sn1[:, k - 3], sn1[:, k - 2], sn1[:, k - 1], 0.153, 111.0,
                           t1[:, k - 3])
    # sn-2: C21, C22, C23 seed C24..C218; C29=C210 is atoms 8-9 of C21..C218.
    n2 = 18
    sn2 = np.zeros((n_lipids, n2, 3))
    sn2[:, 0], sn2[:, 1] = _HEAVY["C21"], _HEAVY["C22"]
    sn2[:, 2] = _zigzag(_SN2_BASE, 2, across=1)
    t2 = _torsions(rng, n_lipids, n2, kink_from=12, p_kink=0.5, noise_deg=8.0)
    t2[:, 10 - 3] = rng.normal(0.0, 5.0, n_lipids)  # C28-C29=C210-C211: cis
    for k in range(3, n2):
        bond = 0.134 if k == 9 else 0.153
        angle = 125.0 if k in (9, 10) else 111.0
        sn2[:, k] = _place(sn2[:, k - 3], sn2[:, k - 2], sn2[:, k - 1], bond, angle,
                           t2[:, k - 3])
    return sn1[:, 1:], sn2


def _ch2(c, a, b, length=0.109):
    """Both hydrogens of a CH2 at ``c`` bonded to ``a`` and ``b``."""
    u = _unit(2 * c - a - b)
    w = _unit(np.cross(a - c, b - c))
    half = np.radians(54.75)
    return (c + length * (np.cos(half) * u + np.sin(half) * w),
            c + length * (np.cos(half) * u - np.sin(half) * w))


def _ch3(c, a, length=0.109):
    """The three hydrogens of a methyl at ``c`` bonded to ``a``."""
    t = _unit(c - a)
    ref = np.where(np.abs(t[..., 2:3]) < 0.9, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0])
    p1 = _unit(np.cross(t, ref))
    p2 = np.cross(t, p1)
    out = []
    for k in range(3):
        ph = np.radians(120.0 * k)
        out.append(c + length * (np.cos(np.radians(70.5)) * t + np.sin(np.radians(70.5))
                                 * (np.cos(ph) * p1 + np.sin(ph) * p2)))
    return out


#: The closest two atoms of a lipid may come (nm): every bond is longer
#: (C-H 0.108), so a lipid whose chains cross below it is drawn again.
MIN_APART_NM = 0.1
#: Rows of the two chains from their second carbon: C22-C218 and C32-C316
#: with their hydrogens.
_SN2_ROWS = np.r_[NAMES.index("C22"):NAMES.index("C3"), NAMES.index("C23"):NAMES.index("C33")]
_SN1_ROWS = np.r_[NAMES.index("C32"):NAMES.index("C23"), NAMES.index("C33"):len(NAMES)]


def _crossed(atoms, block: int = 1024) -> np.ndarray:
    """Which lipids of ``atoms`` (n, 134, 3) have an atom of one chain
    closer than :data:`MIN_APART_NM` to one of the other (the head group
    and glycerol are fixed, and a chain's own torsions keep its atoms
    apart)."""
    out = np.zeros(len(atoms), bool)
    for s in range(0, len(atoms), block):
        a = atoms[s:s + block, _SN2_ROWS]
        b = atoms[s:s + block, _SN1_ROWS]
        d2 = ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1)
        out[s:s + block] = d2.reshape(len(a), -1).min(1) < MIN_APART_NM ** 2
    return out


def lipids_in_frame(rng, n_lipids: int) -> np.ndarray:
    """Every atom of ``n_lipids`` POPC in their own frames: (n_lipids, 134,
    3); the lipids whose chains cross are drawn again until none does."""
    atoms = _draw_lipids(rng, n_lipids)
    for _ in range(50):
        bad = np.flatnonzero(_crossed(atoms))
        if not len(bad):
            return atoms
        atoms[bad] = _draw_lipids(rng, len(bad))
    raise RuntimeError("lipid chains still cross after 50 draws")


def _draw_lipids(rng, n_lipids: int) -> np.ndarray:
    sn1, sn2 = _chains(rng, n_lipids)
    pos = {name: np.broadcast_to(x, (n_lipids, 3)) for name, x in _HEAVY.items()}
    for k in range(2, 17):
        pos[f"C3{k}"] = sn1[:, k - 1]
    for k in range(1, 19):
        pos[f"C2{k}"] = sn2[:, k - 1]
    heavy_of = {"C11": ("O12", "C12"), "C12": ("C11", "N"), "C1": ("O11", "C2"),
                "C3": ("C2", "O31")}
    pairs = {"C11": ("H11A", "H11B"), "C12": ("H12A", "H12B"), "C1": ("HA", "HB"),
             "C3": ("HX", "HY"), "C22": ("H2R", "H2S"), "C32": ("H2X", "H2Y")}
    heavy_of["C22"] = ("C21", "C23")
    heavy_of["C32"] = ("C31", "C33")
    for prefix, last, hyd in (("2", 18, _CH2), ("3", 16, _CH2_SN1)):
        for k in range(3, last):
            if prefix == "2" and k in (9, 10):
                continue
            heavy_of[f"C{prefix}{k}"] = (f"C{prefix}{k - 1}", f"C{prefix}{k + 1}")
            pairs[f"C{prefix}{k}"] = (f"H{k}{hyd[0]}", f"H{k}{hyd[1]}")
    for c, (a, b) in heavy_of.items():
        pos[pairs[c][0]], pos[pairs[c][1]] = _ch2(pos[c], pos[a], pos[b])
    for c, a, names in (("C13", "N", ("H13A", "H13B", "H13C")),
                        ("C14", "N", ("H14A", "H14B", "H14C")),
                        ("C15", "N", ("H15A", "H15B", "H15C")),
                        ("C218", "C217", ("H18R", "H18S", "H18T")),
                        ("C316", "C315", ("H16X", "H16Y", "H16Z"))):
        for name, h in zip(names, _ch3(pos[c], pos[a])):
            pos[name] = h
    for c, a, b, name in (("C29", "C28", "C210", "H91"), ("C210", "C29", "C211", "H101")):
        pos[name] = pos[c] + 0.108 * _unit(2 * pos[c] - pos[a] - pos[b])
    pos["HS"] = pos["C2"] + 0.109 * _unit(3 * pos["C2"] - pos["C1"] - pos["C3"] - pos["O21"])
    return np.stack([np.broadcast_to(pos[name], (n_lipids, 3)) for name in NAMES], axis=1).copy()


def _rotation_to(n):
    """Rotations (..., 3, 3) that take +z to the unit vectors ``n`` (each
    with a positive z)."""
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(z, n)
    s = np.linalg.norm(v, axis=-1)[..., None, None]
    c = n[..., 2][..., None, None]
    vx = np.zeros(n.shape[:-1] + (3, 3))
    vx[..., 0, 1], vx[..., 0, 2] = -v[..., 2], v[..., 1]
    vx[..., 1, 0], vx[..., 1, 2] = v[..., 2], -v[..., 0]
    vx[..., 2, 0], vx[..., 2, 1] = -v[..., 1], v[..., 0]
    return np.eye(3) + vx + vx @ vx / (1 + c)


def height_field(rng, side_nm: float, rms_nm: float, max_mode: int):
    """A periodic height field of the lowest Fourier modes (mode numbers up
    to ``max_mode``, amplitudes as 1/q^2, a Helfrich sheet's spectrum,
    phases seeded), scaled to ``rms_nm`` -> (h(x, y), dh/dx, dh/dy) as
    functions of (n,) arrays."""
    modes = [(i, j) for i in range(-max_mode, max_mode + 1) for j in range(0, max_mode + 1)
             if (j > 0 or i > 0) and i * i + j * j <= max_mode * max_mode]
    q = np.array([[2 * np.pi * i / side_nm, 2 * np.pi * j / side_nm] for i, j in modes])
    amp = rng.normal(size=len(modes)) / (q ** 2).sum(1)
    phase = rng.uniform(0, 2 * np.pi, len(modes))
    amp *= rms_nm / np.sqrt(0.5 * (amp ** 2).sum())

    def at(x, y):
        arg = np.outer(x, q[:, 0]) + np.outer(y, q[:, 1]) + phase
        h = (amp * np.cos(arg)).sum(1)
        gx = -(amp * q[:, 0] * np.sin(arg)).sum(1)
        gy = -(amp * q[:, 1] * np.sin(arg)).sum(1)
        return h, gx, gy

    return at


def build(config: dict) -> dict:
    """A configuration's bilayer: ``box`` (3, 3) f32 (columns are the box
    vectors), ``coords`` (n, 3) f32, ``labels`` (``names``, ``resnames``,
    ``resid`` from 1, ``elements``), ``masses`` and ``leaflet`` (a lipid's
    +1 upper, -1 lower), from the configuration's ``structure_seed``."""
    b = config["bilayer"]
    side = int(b["lipids_a_leaflet_side"])
    n_lipids = 2 * side * side
    if n_lipids * len(NAMES) != config["atoms"] or n_lipids != config["composition"]["POPC"]:
        raise ValueError(f"{n_lipids} POPC of {len(NAMES)} atoms do not make the "
                         f"configuration's {config['atoms']} atoms")
    lx, ly, lz = (float(v) for v in config["box"]["sides_nm"])
    if abs(lx * ly / (side * side) / float(b["area_per_lipid_nm2"]) - 1) > 1e-3:
        raise ValueError(f"a {lx} x {ly} nm leaflet of {side} x {side} lipids is not "
                         f"{b['area_per_lipid_nm2']} nm^2 a lipid")
    rng = np.random.default_rng(int(config["structure_seed"]))
    heights = height_field(rng, lx, float(b["undulation_rms_nm"]), int(b["undulation_modes"]))
    a = lx / side
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    sites = np.stack([i.ravel(), j.ravel()], axis=1).astype(np.float64)
    xy = np.concatenate([(sites + 0.25) * a, (sites + 0.75) * a])
    xy += rng.normal(0.0, float(b["site_jitter_nm"]), xy.shape)
    leaflet = np.repeat([1.0, -1.0], side * side)
    h, gx, gy = heights(xy[:, 0], xy[:, 1])
    normal = _unit(np.stack([-gx, -gy, np.ones_like(h)], axis=1))
    mid = np.stack([xy[:, 0], xy[:, 1], 0.5 * lz + h], axis=1)
    # Each lipid's axis: the leaflet's normal, tilted by a seeded angle.
    tilt = np.radians(np.abs(rng.normal(0.0, float(b["tilt_sd_deg"]), n_lipids)))
    az = rng.uniform(0, 2 * np.pi, n_lipids)
    local = np.stack([np.sin(tilt) * np.cos(az), np.sin(tilt) * np.sin(az), np.cos(tilt)], 1)
    axis = np.einsum("lij,lj->li", _rotation_to(normal), local)
    spin = rng.uniform(0, 2 * np.pi, n_lipids)
    cs, sn = np.cos(spin), np.sin(spin)
    rz = np.zeros((n_lipids, 3, 3))
    rz[:, 0, 0], rz[:, 0, 1], rz[:, 1, 0], rz[:, 1, 1], rz[:, 2, 2] = cs, -sn, sn, cs, 1.0
    # A lower-leaflet lipid is turned over (+z to -z) before it is stood up.
    flip = np.where(leaflet[:, None, None] > 0, np.eye(3), np.diag([1.0, -1.0, -1.0]))
    rot = _rotation_to(axis) @ flip @ rz
    atoms = lipids_in_frame(rng, n_lipids)
    phos = mid + float(b["phosphate_offset_nm"]) * normal * leaflet[:, None]
    coords = np.einsum("lij,laj->lai", rot, atoms) + phos[:, None, :]
    elements = [element(n) for n in NAMES] * n_lipids
    return {
        "box": np.diag([lx, ly, lz]).astype(np.float32),
        "coords": coords.reshape(-1, 3).astype(np.float32),
        "labels": {"names": NAMES * n_lipids, "resnames": ["POPC"] * (n_lipids * len(NAMES)),
                   "resid": np.repeat(np.arange(1, n_lipids + 1), len(NAMES)),
                   "elements": elements},
        "masses": np.array([MASSES[e] for e in elements[:len(NAMES)]] * n_lipids, np.float64),
        "leaflet": leaflet,
    }
