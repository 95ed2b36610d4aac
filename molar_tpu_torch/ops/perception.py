"""Molecular perception from the connection table: SSSR rings, aromaticity,
valence / implicit hydrogens.

The port's own copy of ``molar_tpu.ops.perception`` (numpy only;
``ff/espaloma.py`` reads its :func:`sssr` / :func:`sssr_rings`). Semantics
parity with the reference (molar/src/perception.rs):

* SSSR = smallest ring through every bond (BFS shortest cycle avoiding the
  closing edge, candidates in ascending bond order for stable ties) + GF(2)
  linear independence over the edge set, stopping at the cyclomatic number;
* ring aromaticity: 5-6 rings only; trust all-Aromatic input bonds; else
  Hueckel over sp2 ring atoms — C needs a ring double bond (exocyclic double
  or sp3 C breaks it), N contributes 1 (pyridine) or 2 (pyrrole), O/S lone
  pair 2 (a double bond on O/S breaks it); pi in {2, 6, 10};
* ``perceive`` writes in place: Aromatic order on aromatic-ring bonds,
  IN_RING/AROMATIC atom flags; returns rings + net formal charge;
* implicit H = round(target_valence(z, formal charge) - sum bond valences),
  aromatic bond valence 1.0 for 5-ring N and O/S, 1.5 otherwise.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from ..core.atom import AROMATIC, IN_RING, BondOrder
from ..core.topology import Topology


@dataclass
class Perception:
    rings: list[list[int]]
    aromatic: list[bool]
    total_charge: float

    def aromatic_rings(self) -> list[list[int]]:
        return [r for r, a in zip(self.rings, self.aromatic) if a]


class _Graph:
    """Adjacency with bond indices, over (n_atoms, bonds (nb,2))."""

    def __init__(self, n_atoms: int, bonds: np.ndarray):
        self.n_atoms = n_atoms
        self.bonds = np.asarray(bonds).reshape(-1, 2)
        self.adj: list[list[tuple[int, int]]] = [[] for _ in range(n_atoms)]
        for bi, (a, b) in enumerate(self.bonds):
            self.adj[a].append((int(b), bi))
            self.adj[b].append((int(a), bi))

    @property
    def n_bonds(self) -> int:
        return len(self.bonds)


def _connected_components(g: _Graph) -> int:
    seen = [False] * g.n_atoms
    count = 0
    for s in range(g.n_atoms):
        if seen[s]:
            continue
        count += 1
        seen[s] = True
        q = deque([s])
        while q:
            x = q.popleft()
            for y, _ in g.adj[x]:
                if not seen[y]:
                    seen[y] = True
                    q.append(y)
    return count


def _shortest_cycle(g: _Graph, u: int, v: int, excl: int):
    """Smallest ring through bond (u,v) (excl = the closing edge)."""
    prev = [-1] * g.n_atoms
    prev_bond = [-1] * g.n_atoms
    visited = [False] * g.n_atoms
    visited[u] = True
    q = deque([u])
    while q:
        x = q.popleft()
        if x == v:
            break
        for y, bi in g.adj[x]:
            if bi == excl or visited[y]:
                continue
            visited[y] = True
            prev[y] = x
            prev_bond[y] = bi
            q.append(y)
    if not visited[v]:
        return None
    atoms = []
    bonds = [excl]
    cur = v
    while cur != u:
        atoms.append(cur)
        bonds.append(prev_bond[cur])
        cur = prev[cur]
        if cur == -1:
            return None
    atoms.append(u)
    atoms.reverse()
    return atoms, bonds


def sssr(n_atoms: int, bonds: np.ndarray) -> list[tuple[list[int], list[int]]]:
    """Smallest set of smallest rings -> [(atom cycle, bond indices), ...]."""
    g = _Graph(n_atoms, bonds)
    e = g.n_bonds
    if n_atoms == 0 or e == 0:
        return []
    mu = max(e - n_atoms + _connected_components(g), 0)
    if mu == 0:
        return []
    cands = []
    for bi, (u, v) in enumerate(g.bonds):
        if u == v:
            continue
        r = _shortest_cycle(g, int(u), int(v), bi)
        if r is not None:
            cands.append(r)
    cands.sort(key=lambda r: len(r[1]))  # stable: ties keep bond order

    basis: list[tuple[int, int]] = []  # (pivot bit, row as python int)
    chosen = []
    for atoms, bonds_ in cands:
        if len(chosen) == mu:
            break
        bits = 0
        for bi in bonds_:
            bits |= 1 << bi
        for piv, row in basis:
            if bits >> piv & 1:
                bits ^= row
        if bits:
            piv = (bits & -bits).bit_length() - 1
            basis.append((piv, bits))
            chosen.append((atoms, bonds_))
    return chosen


def sssr_rings(n_atoms: int, bonds: np.ndarray) -> list[list[int]]:
    return [atoms for atoms, _ in sssr(n_atoms, bonds)]


def _ring_is_aromatic(atoms, ring_bonds, g: _Graph, orders, z, in_ring) -> bool:
    sz = len(atoms)
    if not 5 <= sz <= 6:
        return False
    if all(orders[bi] == BondOrder.AROMATIC for bi in ring_bonds):
        return True
    pi = 0
    for a in atoms:
        ring_double = False
        for nb, bi in g.adj[a]:
            if orders[bi] == BondOrder.DOUBLE:
                if in_ring[nb]:
                    ring_double = True
                else:
                    return False  # exocyclic double bond
        za = int(z[a])
        if za == 6:
            if ring_double:
                pi += 1
            else:
                return False  # sp3 carbon
        elif za == 7:
            pi += 1 if ring_double else 2
        elif za in (8, 16):
            if ring_double:
                return False
            pi += 2
        else:
            return False
    return pi in (2, 6, 10)


def rings_with_aromaticity(n_atoms, bonds, orders, z):
    rings = sssr(n_atoms, bonds)
    g = _Graph(n_atoms, bonds)
    in_ring = np.zeros(n_atoms, dtype=bool)
    for atoms, _ in rings:
        in_ring[atoms] = True
    aromatic = [
        _ring_is_aromatic(atoms, rb, g, orders, z, in_ring) for atoms, rb in rings
    ]
    return rings, aromatic


def perceive(top: Topology) -> Perception:
    """Perceive rings + aromaticity, annotating the topology in place
    (Aromatic bond orders + IN_RING/AROMATIC flags). Destructive of Kekule
    structure; idempotent."""
    n = top.n_atoms
    total_charge = (
        float(top.formal_charge.sum()) if top.formal_charge is not None else 0.0
    )
    orders = (
        list(top.bond_orders)
        if top.bond_orders is not None
        else [BondOrder.UNSPECIFIED] * top.n_bonds
    )
    orders = [BondOrder(int(o)) for o in orders]
    rings, aromatic = rings_with_aromaticity(n, top.bonds, orders, top.atomic_number)

    flags = top.ensure_flags()
    new_orders = np.array([int(o) for o in orders], dtype=np.uint8)
    for atoms, _ in rings:
        flags[atoms] |= IN_RING
    for (atoms, ring_bonds), is_arom in zip(rings, aromatic):
        if is_arom:
            for bi in ring_bonds:
                new_orders[bi] = int(BondOrder.AROMATIC)
            flags[atoms] |= AROMATIC
    top.set_bond_orders(new_orders)
    return Perception(
        rings=[atoms for atoms, _ in rings], aromatic=aromatic, total_charge=total_charge
    )


# ---------------------------------------------------------------------------
# Valence / implicit hydrogens
# ---------------------------------------------------------------------------

_BASE_VALENCE = {1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 17: 1, 35: 1, 53: 1, 15: 3, 16: 2}


def target_valence(z: int, fc: int) -> int:
    base = _BASE_VALENCE.get(z, 0)
    if base == 0:
        return 0
    if z == 6:
        return max(base - abs(fc), 0)
    if z in (7, 15, 8, 16):
        return base + fc
    return max(base + fc, 0)


def _bond_valence(order: BondOrder, z: int, ring_size: int) -> float:
    if order in (BondOrder.SINGLE, BondOrder.UNSPECIFIED):
        return 1.0
    if order == BondOrder.DOUBLE:
        return 2.0
    if order == BondOrder.TRIPLE:
        return 3.0
    # aromatic
    if z == 7 and ring_size == 5:
        return 1.0
    if z in (8, 16):
        return 1.0
    return 1.5


def implicit_hydrogens(top: Topology) -> np.ndarray:
    """Per-atom implicit H counts (perception.rs implicit_hydrogens)."""
    n = top.n_atoms
    g = _Graph(n, top.bonds)
    orders = (
        [BondOrder(int(o)) for o in top.bond_orders]
        if top.bond_orders is not None
        else [BondOrder.UNSPECIFIED] * top.n_bonds
    )
    fc = (
        top.formal_charge if top.formal_charge is not None else np.zeros(n, np.int8)
    )
    ring_size = np.zeros(n, dtype=np.int64)
    if any(o == BondOrder.AROMATIC for o in orders):
        for atoms, _ in sssr(n, top.bonds):
            sz = len(atoms)
            for a in atoms:
                if ring_size[a] == 0 or sz < ring_size[a]:
                    ring_size[a] = sz
    out = np.zeros(n, dtype=np.uint8)
    z = top.atomic_number
    for i in range(n):
        explicit = sum(
            _bond_valence(orders[bi], int(z[i]), int(ring_size[i]))
            for _, bi in g.adj[i]
        )
        target = target_valence(int(z[i]), int(fc[i]))
        out[i] = max(round(target - explicit), 0)
    return out
