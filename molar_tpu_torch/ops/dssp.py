"""DSSP secondary structure (Kabsch-Sander + GROMACS flavor).

Pipeline parity with the reference (molar/src/dssp.rs, secondary_structure.rs):

1. backbone extraction per residue (N/CA/C/O; O|OT1|OXT accepted; explicit
   H|HN|1H|H1 kept but later overwritten) — missing atoms => Break;
2. amide H reconstruction: ``H_i = N_i + normalize(C_{i-1} - O_{i-1}) * 0.1``
   (gmx dssp -hmode dssp), prolines included (matching the reference);
3. H-bonds: E = 0.084*33.2*(1/rON + 1/rCH - 1/rOH - 1/rCN) < -0.5 kcal/mol,
   |donor - acceptor| >= 2;
4. helices in GROMACS order (alpha, 3-10, pi) with per-type blocking
   priorities, interior turn marking;
5. beta: ``vanilla`` = canonical ladders + bounded asymmetric bulge merge
   (E only for ladders > 1 bridge); ``gmx`` = range-fill between bridge
   partners closer than 6 (over-extends strands, kept for gmx parity);
6. bends (Ca angle >= 70 deg), 7. polyproline II (phi/psi windows).

Codes: H G I P E B T S ~ =  (secondary_structure.rs:34-50); assignment by
strictly-higher priority (Break 255 > H 8 > B 7 > E 6 > G 5 > I 4 > T 3 >
S 2 > P 1 > coil 0).

Residue count is small (10^2..10^3), so this runs host-side with a
vectorized O(n^2) energy matrix; trajectory batching = python loop over
frames (the per-frame cost is microseconds at protein scale).

The port's copy of ``molar_tpu.ops.dssp`` (numpy only), behind ``Sel.dssp``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np


class SS(enum.Enum):
    ALPHA_HELIX = "H"
    HELIX_310 = "G"
    PI_HELIX = "I"
    POLYPROLINE = "P"
    BETA_SHEET = "E"
    BETA_BRIDGE = "B"
    TURN = "T"
    BEND = "S"
    COIL = "~"
    BREAK = "="


_PRIORITY = {
    SS.BREAK: 255,
    SS.ALPHA_HELIX: 8,
    SS.BETA_BRIDGE: 7,
    SS.BETA_SHEET: 6,
    SS.HELIX_310: 5,
    SS.PI_HELIX: 4,
    SS.TURN: 3,
    SS.BEND: 2,
    SS.POLYPROLINE: 1,
    SS.COIL: 0,
}

HBOND_FACTOR = 0.084 * 33.2
HBOND_THRESHOLD = -0.5


@dataclass
class _Residue:
    n: int = -1
    ca: int = -1
    c: int = -1
    o: int = -1
    h: Optional[np.ndarray] = None

    @property
    def valid(self) -> bool:
        return self.n >= 0 and self.ca >= 0 and self.c >= 0 and self.o >= 0


def _try_assign(ss: list[SS], k: int, new: SS) -> None:
    if _PRIORITY[new] > _PRIORITY[ss[k]]:
        ss[k] = new


def _extract_backbone(names, resindex) -> list[_Residue]:
    by_res: dict[int, _Residue] = {}
    for local, (name, ri) in enumerate(zip(names, resindex)):
        e = by_res.setdefault(int(ri), _Residue())
        if name == "N":
            e.n = local
        elif name == "CA":
            e.ca = local
        elif name == "C":
            e.c = local
        elif name in ("O", "OT1", "OXT"):
            if e.o < 0:
                e.o = local
        elif name in ("H", "HN", "1H", "H1"):
            e.h = local  # stored as index; replaced by reconstruction
    return [by_res[k] for k in sorted(by_res)]


def _dihedral_gmx(a, b, c, d) -> float:
    """Dihedral A-B-C-D, GROMACS formula, degrees; 360 for degenerate."""
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


class Dssp:
    """One-shot DSSP over a selection's (names, resindex, coords)."""

    def __init__(self, names, resindex, coords, beta: str = "vanilla"):
        coords = np.asarray(coords, dtype=np.float64)
        self.backbone = _extract_backbone(names, resindex)
        n = len(self.backbone)
        self.ss: list[SS] = [
            SS.COIL if r.valid else SS.BREAK for r in self.backbone
        ]
        self._coords = coords
        self._h = self._reconstruct_h()
        self.hbond = self._compute_hbonds()
        self._detect_helices()
        if beta == "gmx":
            self._detect_beta_gmx()
        else:
            self._detect_beta_vanilla()
        self._detect_bends()
        self._detect_polyproline()

    # -- accessors -----------------------------------------------------------

    def ss_string(self) -> str:
        return "".join(s.value for s in self.ss)

    def __len__(self) -> int:
        return len(self.ss)

    # -- stage 2: H reconstruction -------------------------------------------

    def _reconstruct_h(self) -> list[Optional[np.ndarray]]:
        c = self._coords
        out: list[Optional[np.ndarray]] = []
        for r in self.backbone:
            if r.valid and r.h is not None and isinstance(r.h, (int, np.integer)):
                out.append(c[r.h].copy())
            else:
                out.append(None)
        for i in range(1, len(self.backbone)):
            prev, cur = self.backbone[i - 1], self.backbone[i]
            if not (prev.valid and cur.valid):
                continue
            v = c[prev.c] - c[prev.o]
            norm = np.linalg.norm(v)
            if norm > 1e-6:
                out[i] = c[cur.n] + v / norm * 0.1
        return out

    # -- stage 3: H-bonds ------------------------------------------------------

    def _compute_hbonds(self) -> set[tuple[int, int]]:
        n = len(self.backbone)
        valid = np.array([r.valid for r in self.backbone])
        has_h = np.array([h is not None for h in self._h])
        donors = np.nonzero(valid & has_h)[0]
        acceptors = np.nonzero(valid)[0]
        if len(donors) == 0 or len(acceptors) == 0:
            return set()
        c = self._coords
        dn = c[[self.backbone[i].n for i in donors]]
        dh = np.stack([self._h[i] for i in donors])
        ac = c[[self.backbone[j].c for j in acceptors]]
        ao = c[[self.backbone[j].o for j in acceptors]]

        def dist(a, b):
            return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=2)

        r_on = dist(dn, ao)
        r_ch = dist(dh, ac)
        r_oh = dist(dh, ao)
        r_cn = dist(dn, ac)
        degenerate = (r_oh < 1e-4) | (r_on < 1e-4) | (r_ch < 1e-4) | (r_cn < 1e-4)
        with np.errstate(divide="ignore"):
            e = HBOND_FACTOR * (1 / r_on + 1 / r_ch - 1 / r_oh - 1 / r_cn)
        e = np.where(degenerate, 0.0, e)
        sep = np.abs(donors[:, None] - acceptors[None, :])
        mask = (e < HBOND_THRESHOLD) & (sep >= 2)
        di, aj = np.nonzero(mask)
        return {(int(donors[i]), int(acceptors[j])) for i, j in zip(di, aj)}

    # -- stage 4: helices -------------------------------------------------------

    def _detect_helices(self) -> None:
        n = len(self.backbone)
        bb = self.backbone
        hb = self.hbond
        turns = {}
        for t, n_turn in ((0, 3), (1, 4), (2, 5)):
            arr = [False] * n
            for i in range(n):
                if (
                    i + n_turn < n
                    and bb[i].valid
                    and bb[i + n_turn].valid
                    and (i + n_turn, i) in hb
                ):
                    arr[i] = True
            turns[n_turn] = arr
        for n_turn, code, blocker in (
            (4, SS.ALPHA_HELIX, 255),
            (3, SS.HELIX_310, _PRIORITY[SS.BETA_SHEET]),
            (5, SS.PI_HELIX, _PRIORITY[SS.HELIX_310]),
        ):
            arr = turns[n_turn]
            for i in range(n):
                if arr[i] and i + 1 < n and arr[i + 1]:
                    lo = i + 1
                    hi = min(i + n_turn, n - 1)
                    if any(_PRIORITY[self.ss[k]] >= blocker for k in range(lo, hi + 1)):
                        continue
                    for k in range(lo, hi + 1):
                        _try_assign(self.ss, k, code)
            for i in range(n):
                if arr[i]:
                    for k in range(i + 1, min(i + n_turn, n)):
                        _try_assign(self.ss, k, SS.TURN)

    # -- stage 5: beta -----------------------------------------------------------

    def _detect_beta_vanilla(self) -> None:
        n = len(self.backbone)
        if n < 5:
            return
        bb = self.backbone
        hb = self.hbond
        ladders: list[list] = []  # [anti, i0, i1, j0, j1]
        for i in range(1, max(n - 4, 0)):
            if not (bb[i - 1].valid and bb[i].valid and bb[i + 1].valid):
                continue
            for j in range(i + 3, n - 1):
                if not (bb[j - 1].valid and bb[j].valid and bb[j + 1].valid):
                    continue
                anti_hit = ((i + 1, j - 1) in hb and (j + 1, i - 1) in hb) or (
                    (j, i) in hb and (i, j) in hb
                )
                par_hit = ((i + 1, j) in hb and (j, i - 1) in hb) or (
                    (j + 1, i) in hb and (i, j - 1) in hb
                )
                if anti_hit:
                    anti = True
                elif par_hit:
                    anti = False
                else:
                    continue
                extended = False
                for lad in ladders:
                    if (
                        lad[0] == anti
                        and lad[2] + 1 == i
                        and (lad[4] == j + 1 if anti else lad[4] + 1 == j)
                    ):
                        lad[2] = i
                        lad[4] = j
                        extended = True
                        break
                if not extended:
                    ladders.append([anti, i, i, j, j])

        def has_break(lo, hi):
            lo, hi = min(lo, hi), max(lo, hi)
            return any(not bb[k].valid for k in range(lo, hi + 1))

        ladders.sort(key=lambda l: l[1])
        merged = True
        while merged:
            merged = False
            for a in range(len(ladders)):
                for b in range(len(ladders)):
                    if a == b or ladders[a][0] != ladders[b][0]:
                        continue
                    la, lb = ladders[a], ladders[b]
                    gap_i = lb[1] - la[2]
                    if gap_i <= 0 or gap_i >= 6:
                        continue
                    gap_j = (la[3] - lb[4]) if la[0] else (lb[3] - la[4])
                    if gap_j <= 0:
                        continue
                    if not ((gap_j < 6 and gap_i < 3) or gap_j < 3):
                        continue
                    if has_break(la[2], lb[1]) or has_break(la[4], lb[4]):
                        continue
                    la[2] = lb[2]
                    la[4] = lb[4]
                    ladders.pop(b)
                    merged = True
                    break
                if merged:
                    break

        for anti, i0, i1, j0, j1 in ladders:
            code = SS.BETA_SHEET if i1 > i0 else SS.BETA_BRIDGE
            for k in range(i0, i1 + 1):
                _try_assign(self.ss, k, code)
            for k in range(min(j0, j1), max(j0, j1) + 1):
                _try_assign(self.ss, k, code)

    def _detect_beta_gmx(self) -> None:
        n = len(self.backbone)
        if n < 5:
            return
        bb = self.backbone
        ap, par, _ = self._bridge_types_gmx()

        def res_break(i):
            return (
                i == 0
                or i + 1 >= n
                or not bb[i - 1].valid
                or not bb[i + 1].valid
            )

        for i in range(1, n - 1):
            for gap in (1, 2):
                ij = i + gap
                if ij >= n:
                    continue
                if res_break(i) or res_break(ij):
                    continue
                for pi, pij in ((ap[i], ap[ij]), (par[i], par[ij])):
                    if not pi or not pij:
                        continue
                    for ip in pi:
                        for jp in pij:
                            if abs(ip - jp) < 6:
                                for k in range(min(ip, jp), max(ip, jp) + 1):
                                    _try_assign(self.ss, k, SS.BETA_SHEET)
                                for k in range(i, ij + 1):
                                    _try_assign(self.ss, k, SS.BETA_SHEET)
        for i in range(1, n - 1):
            if not bb[i].valid:
                continue
            if self.ss[i] != SS.BETA_SHEET and (ap[i] or par[i]):
                _try_assign(self.ss, i, SS.BETA_BRIDGE)

    def _bridge_types_gmx(self):
        """gmx flavor records BOTH bridge types independently (no elif)."""
        n = len(self.backbone)
        bb = self.backbone
        hb = self.hbond
        ap: list[list[int]] = [[] for _ in range(n)]
        par: list[list[int]] = [[] for _ in range(n)]
        for i in range(1, max(n - 4, 0)):
            if not (bb[i - 1].valid and bb[i].valid and bb[i + 1].valid):
                continue
            for j in range(i + 3, n - 1):
                if not (bb[j - 1].valid and bb[j].valid and bb[j + 1].valid):
                    continue
                if ((i + 1, j - 1) in hb and (j + 1, i - 1) in hb) or (
                    (j, i) in hb and (i, j) in hb
                ):
                    ap[i].append(j)
                    ap[j].append(i)
                if ((i + 1, j) in hb and (j, i - 1) in hb) or (
                    (j + 1, i) in hb and (i, j - 1) in hb
                ):
                    par[i].append(j)
                    par[j].append(i)
        return ap, par, None

    # -- stage 6: bends ------------------------------------------------------------

    def _detect_bends(self) -> None:
        n = len(self.backbone)
        c = self._coords
        bb = self.backbone
        for i in range(2, max(n - 2, 0)):
            if not (bb[i - 2].valid and bb[i].valid and bb[i + 2].valid):
                continue
            v1 = c[bb[i].ca] - c[bb[i - 2].ca]
            v2 = c[bb[i + 2].ca] - c[bb[i].ca]
            n1 = np.linalg.norm(v1)
            n2 = np.linalg.norm(v2)
            if n1 < 1e-6 or n2 < 1e-6:
                continue
            ang = np.degrees(np.arccos(np.clip(v1 @ v2 / (n1 * n2), -1.0, 1.0)))
            if ang >= 70.0:
                _try_assign(self.ss, i, SS.BEND)

    # -- stage 7: polyproline II ------------------------------------------------------

    def _detect_polyproline(self) -> None:
        n = len(self.backbone)
        c = self._coords
        bb = self.backbone
        phi = [360.0] * n
        psi = [360.0] * n
        for i in range(1, max(n - 1, 0)):
            if not (bb[i - 1].valid and bb[i].valid):
                continue
            phi[i] = _dihedral_gmx(c[bb[i - 1].c], c[bb[i].n], c[bb[i].ca], c[bb[i].c])
            if bb[i + 1].valid:
                psi[i] = _dihedral_gmx(c[bb[i].n], c[bb[i].ca], c[bb[i].c], c[bb[i + 1].n])
        phi_lo, phi_hi = -104.0, -46.0
        psi_lo, psi_hi = 116.0, 174.0

        def ok(k):
            return phi_lo <= phi[k] <= phi_hi and psi_lo <= psi[k] <= psi_hi

        for i in range(1, n):
            if i + 3 >= n:
                break
            if ok(i) and ok(i + 1) and ok(i + 2):
                for k in (i, i + 1, i + 2):
                    _try_assign(self.ss, k, SS.POLYPROLINE)


def compute_dssp(sel, flavor: str = "vanilla") -> Dssp:
    """Run DSSP on a Sel (uses local selection coords; no PBC)."""
    return Dssp(
        sel.names, sel.topology.resindex[sel.indices], sel.coords, beta=flavor
    )
