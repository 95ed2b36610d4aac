"""PyMOL-style secondary structure (``dss``): fast 3-state H/E/~ assignment.

Clean-room reimplementation of the algorithm semantics documented by the
reference (molar/src/dss.rs, itself a clean-room port of PyMOL's
SelectorAssignSS): a heavy-atom backbone H-bond test with an angle-dependent
distance cutoff (63 deg max, 0.32/0.40 nm power-law curve), phi/psi
include/exclude windows, H-bond pattern flags (helix 3/4/5 turns,
anti/parallel ladders, bulges), helix/strand assignment rules, and a cleanup
pass enforcing minimum element length 3 with genuinely paired terminal strand
residues. Distances in nm.

The port's copy of ``molar_tpu.ops.dss`` (numpy only), behind ``Sel.dss``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MAX_ANGLE = 63.0
MAX_DIST_AT_MAX_ANGLE = 0.32
MAX_DIST_AT_ZERO = 0.40
POWER_A = 1.6
POWER_B = 5.0
H_BOND_LEN = 0.1

HELIX_PHI_TARGET = -57.0
HELIX_PSI_TARGET = -48.0
HELIX_INCLUDE = 55.0
HELIX_EXCLUDE = 85.0
STRAND_PHI_TARGET = -129.0
STRAND_PSI_TARGET = 124.0
STRAND_INCLUDE = 40.0
STRAND_PHI_EXCLUDE = 100.0
STRAND_PSI_EXCLUDE = 90.0

HELIX3 = 0x0001
HELIX4 = 0x0002
HELIX5 = 0x0004
HELIX_HB = HELIX3 | HELIX4 | HELIX5
PHIPSI_HELIX = 0x0010
PHIPSI_NOT_HELIX = 0x0020
PHIPSI_STRAND = 0x0040
PHIPSI_NOT_STRAND = 0x0080
ANTI_SINGLE = 0x0100
ANTI_DOUBLE = 0x0200
ANTI_BULGE = 0x0400
ANTI_SKIP = 0x0800
PARA_SINGLE = 0x1000
PARA_DOUBLE = 0x2000
PARA_SKIP = 0x4000

PAD = 5


class _R:
    __slots__ = ("real", "resindex", "n", "ca", "c", "o", "flags", "ss", "acc", "don")

    def __init__(self):
        self.real = False
        self.resindex = 0
        self.n = self.ca = self.c = self.o = None
        self.flags = 0
        self.ss = "L"
        self.acc: list[int] = []
        self.don: list[int] = []


def _dihedral(a, b, c, d) -> float:
    ba = a - b
    cd = d - c
    cb = b - c
    cbxba = np.cross(cb, ba)
    cbxcd = np.cross(cb, cd)
    cbxcbxcd = np.cross(cb, cbxcd)
    v1 = cbxcd @ cbxcd
    v2 = cbxcbxcd @ cbxcbxcd
    if v1 > 0 and v2 > 0:
        x = (cbxba @ cbxcd) / np.sqrt(v1)
        y = (cbxba @ cbxcbxcd) / np.sqrt(v2)
        return float(np.degrees(np.arctan2(y, x)))
    return 360.0


def _circ_delta(a: float, target: float) -> float:
    d = abs(a - target)
    return 360.0 - d if d > 180.0 else d


def _normalize(v):
    return v / np.linalg.norm(v)


def _is_hbond(n, ca, c_prev, o, c_acc) -> bool:
    don_to_acc = o - n
    dist = float(np.linalg.norm(don_to_acc))
    if dist > MAX_DIST_AT_ZERO:
        return False
    if c_prev is not None:
        u_ca = _normalize(ca - n)
        u_cp = _normalize(c_prev - n)
        s = u_ca + u_cp
        h_dir = _normalize(n - ca) if np.linalg.norm(s) < 1e-6 else -_normalize(s)
    else:
        h_dir = _normalize(n - ca)
    h = n + h_dir * H_BOND_LEN
    plane = _normalize(o - c_acc)
    h_to_acc = _normalize(o - h)
    if h_to_acc @ plane > 0.0:
        return False
    dangle = float(h_dir @ _normalize(don_to_acc))
    if 0.0 < dangle < 1.0:
        angle = float(np.degrees(np.arccos(np.clip(dangle, -1, 1))))
    elif dangle > 0.0:
        angle = 0.0
    else:
        angle = 90.0
    if angle > MAX_ANGLE:
        return False
    factor_a = 0.5 / MAX_ANGLE**POWER_A
    factor_b = 0.5 / MAX_ANGLE**POWER_B
    curve = angle**POWER_A * factor_a + angle**POWER_B * factor_b
    cutoff = MAX_DIST_AT_MAX_ANGLE * curve + MAX_DIST_AT_ZERO * (1 - curve)
    return dist <= cutoff


class Dss:
    """One-shot dss over a selection (names, resindex, chain, coords)."""

    def __init__(self, names, resindex, chains, coords):
        coords = np.asarray(coords, dtype=np.float64)
        by_res: dict[int, dict] = {}
        for local, (name, ri) in enumerate(zip(names, resindex)):
            e = by_res.setdefault(
                int(ri), {"n": None, "ca": None, "c": None, "o": None, "chain": chains[local]}
            )
            if name == "N":
                e["n"] = coords[local]
            elif name == "CA":
                e["ca"] = coords[local]
            elif name == "C":
                e["c"] = coords[local]
            elif name in ("O", "OT1", "OXT") and e["o"] is None:
                e["o"] = coords[local]
        all_ri = sorted(by_res)

        res: list[_R] = [_R() for _ in range(PAD)]
        prev: Optional[tuple[str, int]] = None
        for ri in all_ri:
            bb = by_res[ri]
            complete = all(bb[k] is not None for k in ("n", "ca", "c", "o"))
            if not complete:
                if prev is not None:
                    res.extend(_R() for _ in range(PAD))
                    prev = None
                continue
            if prev is not None and (bb["chain"] != prev[0] or ri != prev[1] + 1):
                res.extend(_R() for _ in range(PAD))
            r = _R()
            r.real = True
            r.resindex = ri
            r.n, r.ca, r.c, r.o = bb["n"], bb["ca"], bb["c"], bb["o"]
            res.append(r)
            prev = (bb["chain"], ri)
        res.extend(_R() for _ in range(PAD))

        if len(res) > 2 * PAD:
            self._detect_hbonds(res)
            self._classify_phi_psi(res)
            self._pattern_flags(res)
            self._assign_helices(res)
            self._assign_strands(res)
            self._cleanup(res)

        ss_by_ri = {
            r.resindex: {"H": "H", "S": "E"}.get(r.ss, "~") for r in res if r.real
        }
        self.ss = [ss_by_ri.get(ri, "~") for ri in all_ri]

    def ss_string(self) -> str:
        return "".join(self.ss)

    def __len__(self) -> int:
        return len(self.ss)

    # -- stages ------------------------------------------------------------

    @staticmethod
    def _detect_hbonds(res: list[_R]) -> None:
        n = len(res)
        # Vectorized prefilter: candidate (acceptor i, donor j) pairs with
        # |O_i - N_j| <= 0.40 nm, then the exact angle test per candidate.
        real = np.array([r.real for r in res])
        idx = np.nonzero(real)[0]
        if len(idx) == 0:
            return
        opos = np.stack([res[i].o for i in idx])
        npos = np.stack([res[i].n for i in idx])
        d = np.linalg.norm(opos[:, None, :] - npos[None, :, :], axis=2)
        ii, jj = np.nonzero(d <= MAX_DIST_AT_ZERO)
        bonds = []
        for a, b in zip(idx[ii], idx[jj]):
            i, j = int(a), int(b)
            if i == j or abs(i - j) <= 2:
                continue
            c_prev = res[j - 1].c if res[j - 1].real else None
            if _is_hbond(res[j].n, res[j].ca, c_prev, res[i].o, res[i].c):
                bonds.append((i, j))
        for i, j in bonds:
            if len(res[i].acc) < 5:
                res[i].acc.append(j)
            if len(res[j].don) < 5:
                res[j].don.append(i)

    @staticmethod
    def _classify_phi_psi(res: list[_R]) -> None:
        n = len(res)
        for a in range(PAD, n - PAD):
            if not (res[a].real and res[a - 1].real and res[a + 1].real):
                continue
            phi = _dihedral(res[a - 1].c, res[a].n, res[a].ca, res[a].c)
            psi = _dihedral(res[a].n, res[a].ca, res[a].c, res[a + 1].n)
            h_phi = _circ_delta(phi, HELIX_PHI_TARGET)
            h_psi = _circ_delta(psi, HELIX_PSI_TARGET)
            s_phi = _circ_delta(phi, STRAND_PHI_TARGET)
            s_psi = _circ_delta(psi, STRAND_PSI_TARGET)
            if h_psi > HELIX_EXCLUDE or h_phi > HELIX_EXCLUDE:
                res[a].flags |= PHIPSI_NOT_HELIX
            elif h_psi < HELIX_INCLUDE and h_phi < HELIX_INCLUDE:
                res[a].flags |= PHIPSI_HELIX
            if s_psi > STRAND_PSI_EXCLUDE or s_phi > STRAND_PHI_EXCLUDE:
                res[a].flags |= PHIPSI_NOT_STRAND
            elif s_psi < STRAND_INCLUDE and s_phi < STRAND_INCLUDE:
                res[a].flags |= PHIPSI_STRAND

    @staticmethod
    def _pattern_flags(res: list[_R]) -> None:
        n = len(res)
        add: list[tuple[int, int]] = []
        for a in range(PAD, n - PAD):
            if not res[a].real:
                continue
            for acc in res[a].acc:
                if acc == a + 3:
                    add.append((a, HELIX3))
                elif acc == a + 4:
                    add.append((a, HELIX4))
                elif acc == a + 5:
                    add.append((a, HELIX5))
            for don in res[a].don:
                if don + 3 == a:
                    add.append((a, HELIX3))
                elif don + 4 == a:
                    add.append((a, HELIX4))
                elif don + 5 == a:
                    add.append((a, HELIX5))
            for r2 in res[a].acc:
                if res[r2].real and a in res[r2].acc:
                    add.append((a, ANTI_DOUBLE))
                    add.append((r2, ANTI_DOUBLE))
            for acc in res[a].acc:
                r2 = acc + 1
                if r2 < n and res[r2].real and a in res[r2].acc:
                    add.append((a, ANTI_DOUBLE))
                    add.append((r2, ANTI_BULGE))
                    add.append((r2 - 1, ANTI_BULGE))
            if res[a + 1].real and res[a + 2].real:
                for acc in res[a].acc:
                    if acc < 2:
                        continue
                    r2 = acc - 2
                    if res[r2].real and (a + 2) in res[r2].acc:
                        add.extend(
                            [
                                (a, ANTI_SINGLE),
                                (a + 1, ANTI_SKIP),
                                (a + 2, ANTI_SINGLE),
                                (r2, ANTI_SINGLE),
                                (r2 + 1, ANTI_SKIP),
                                (r2 + 2, ANTI_SINGLE),
                            ]
                        )
                for acc in res[a].acc:
                    r2 = acc
                    if res[r2].real and (a + 2) in res[r2].acc:
                        add.extend(
                            [
                                (a, PARA_SINGLE),
                                (a + 1, PARA_SKIP),
                                (a + 2, PARA_SINGLE),
                                (r2, PARA_DOUBLE),
                            ]
                        )
        for i, f in add:
            res[i].flags |= f

    @staticmethod
    def _assign_helices(res: list[_R]) -> None:
        n = len(res)
        for a in range(PAD, n - PAD):
            if (
                res[a].real
                and res[a - 1].flags & HELIX_HB
                and res[a].flags & HELIX_HB
                and res[a + 1].flags & HELIX_HB
                and not res[a].flags & PHIPSI_NOT_HELIX
            ):
                res[a].ss = "H"
        for a in range(PAD, n - PAD):
            if (
                res[a].real
                and res[a - 2].flags & HELIX_HB
                and res[a - 1].flags & HELIX_HB
                and res[a - 1].flags & PHIPSI_HELIX
                and res[a].flags & PHIPSI_HELIX
                and res[a + 1].flags & HELIX_HB
                and res[a + 1].flags & PHIPSI_HELIX
                and res[a + 2].flags & HELIX_HB
            ):
                res[a].ss = "h"
        for a in range(PAD, n - PAD):
            if res[a].real and res[a].ss == "h":
                res[a].flags |= HELIX_HB
                res[a].ss = "H"

        def geo(x):
            return x & HELIX_HB and x & PHIPSI_HELIX

        for a in range(PAD, n - PAD):
            if not res[a].real:
                continue
            f = res[a].flags
            if geo(f) and geo(res[a + 1].flags) and geo(res[a + 2].flags) and res[a + 1].ss == "H":
                res[a].ss = "H"
            if geo(f) and geo(res[a - 1].flags) and geo(res[a - 2].flags) and res[a - 1].ss == "H":
                res[a].ss = "H"

    @staticmethod
    def _assign_strands(res: list[_R]) -> None:
        n = len(res)
        for a in range(PAD, n - PAD):
            if not res[a].real:
                continue
            fm1 = res[a - 1].flags
            f = res[a].flags
            fp1 = res[a + 1].flags
            if f & ANTI_DOUBLE and not f & PHIPSI_NOT_STRAND:
                res[a].ss = "S"
            if f & ANTI_BULGE and fp1 & ANTI_BULGE:
                res[a].ss = "S"
                res[a + 1].ss = "S"
            if (
                fm1 & ANTI_DOUBLE
                and f & ANTI_SKIP
                and not f & PHIPSI_NOT_STRAND
                and fp1 & (ANTI_SINGLE | ANTI_DOUBLE)
            ):
                res[a].ss = "S"
            if (
                fm1 & (ANTI_SINGLE | ANTI_DOUBLE)
                and f & ANTI_SKIP
                and not f & PHIPSI_NOT_STRAND
                and fp1 & ANTI_DOUBLE
            ):
                res[a].ss = "S"
            if (
                fm1 & (ANTI_SINGLE | ANTI_DOUBLE)
                and fm1 & PHIPSI_STRAND
                and f & PHIPSI_STRAND
                and fp1 & (ANTI_SINGLE | ANTI_DOUBLE)
                and fp1 & PHIPSI_STRAND
            ):
                res[a - 1].ss = "S"
                res[a].ss = "S"
                res[a + 1].ss = "S"
            if f & PARA_DOUBLE and not f & PHIPSI_NOT_STRAND:
                res[a].ss = "S"
            if (
                fm1 & PARA_DOUBLE
                and f & PARA_SKIP
                and not f & PHIPSI_NOT_STRAND
                and fp1 & (PARA_SINGLE | PARA_DOUBLE)
            ):
                res[a].ss = "S"
            if (
                fm1 & (PARA_SINGLE | PARA_DOUBLE)
                and f & PARA_SKIP
                and not f & PHIPSI_NOT_STRAND
                and fp1 & PARA_DOUBLE
            ):
                res[a].ss = "S"
            if (
                fm1 & (PARA_SINGLE | PARA_DOUBLE)
                and fm1 & PHIPSI_STRAND
                and f & PARA_SKIP
                and f & PHIPSI_STRAND
                and fp1 & (PARA_SINGLE | PARA_DOUBLE)
                and fp1 & PHIPSI_STRAND
            ):
                res[a - 1].ss = "S"
                res[a].ss = "S"
                res[a + 1].ss = "S"

    @staticmethod
    def _cleanup(res: list[_R]) -> None:
        n = len(res)
        repeat = True
        while repeat:
            repeat = False
            for a in range(PAD, n - PAD):
                if not res[a].real:
                    continue
                ss = res[a].ss
                ssm1 = res[a - 1].ss
                ssp1 = res[a + 1].ss
                ssp2 = res[a + 2].ss
                if (ss == "S" and ssp1 == "S" and ssm1 != "S" and ssp2 != "S") or (
                    ss == "H" and ssp1 == "H" and ssm1 != "H" and ssp2 != "H"
                ):
                    res[a].ss = "L"
                    res[a + 1].ss = "L"
                    repeat = True
                    continue
                if (ss == "S" and ssm1 != "S" and ssp1 != "S") or (
                    ss == "H" and ssm1 != "H" and ssp1 != "H"
                ):
                    res[a].ss = "L"
                    repeat = True
                    continue
                if ss == "S" and (ssm1 != "S" or ssp1 != "S"):
                    found = any(res[p].ss == "S" for p in res[a].acc) or any(
                        res[p].ss == "S" for p in res[a].don
                    )
                    if not found and res[a].flags & (ANTI_SKIP | PARA_SKIP):
                        if ssp1 == "S":
                            found = any(res[p].ss == "S" for p in res[a + 1].acc)
                        if not found and ssm1 == "S":
                            found = any(res[p].ss == "S" for p in res[a - 1].don)
                    if not found:
                        res[a].ss = "L"
                        repeat = True


def compute_dss(sel) -> Dss:
    """Run PyMOL-style dss on a Sel."""
    return Dss(
        sel.names,
        sel.topology.resindex[sel.indices],
        sel.topology.chain[sel.indices],
        sel.coords,
    )
