"""Ring perception from the connection table: the smallest set of smallest
rings (SSSR).

The port's own copy of the part of ``molar_tpu.ops.perception`` that
espaloma's featurisation reads (numpy only): the smallest ring through every
bond (BFS shortest cycle avoiding the closing edge, candidates in ascending
bond order for stable ties) plus GF(2) linear independence over the edge
set, stopping at the cyclomatic number (reference: molar/src/perception.rs).
Aromaticity perception of a topology and GAFF typing are not ported.
"""

from __future__ import annotations

from collections import deque

import numpy as np


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
