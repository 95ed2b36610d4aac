"""espaloma-charge partial charges: the bundled ONNX GNN as a torch module.

The counterpart of ``molar_tpu.ff.espaloma`` (reference: molar_ff/src/charge.rs).
Per-atom features ``[n, 116]`` (element one-hot, degree/valence, RDKit-style
Hueckel aromaticity over individual and fused ring systems, mass, ring-size
bits 3..8, hybridization one-hot with neighbour-conjugation SP2 promotion)
and a row-mean-normalised adjacency feed a small GNN that gives each atom an
electronegativity e and a hardness s; the closed-form equilibration
``q_i = -e_i/s_i + (1/s_i) (sum e_j/s_j)/(sum 1/s_j)`` makes the total
charge 0.

The featurisation, the numpy walk of the graph (:func:`run_gnn`, the ground
truth) and the equilibration are the JAX package's, copied: host numpy with
per-atom Python loops. :class:`EspalomaGNN` walks the same 27 nodes (MatMul,
Add, Relu, Tanh, Gather) in torch on an explicit device, at the molecule's
own atom count (there is no compile to bound, so no padding). The products
are plain float32 matrix products: importing :mod:`molar_tpu_torch.config`
pins TF32 off, the counterpart of the JAX package's ``Precision.HIGHEST``.

The model file is read by path from ``molar_tpu/ff/espaloma_charge.onnx``
(reading a file is not an import). Dispatch (:func:`espaloma_charges`): the
torch forward runs on the card unless the caller passes a CPU device or sets
``MOLAR_ESPALOMA_BACKEND=numpy``, which takes the host walk; a failure on
the card raises.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch import nn

from .. import build
from ..config import FLOAT, resolve_device
from ..ops.perception import sssr_rings
from .onnx_mini import Graph, load_model

MODEL_PATH = build.REPO_DIR / "molar_tpu" / "ff" / "espaloma_charge.onnx"

_MASS = {1: 1.008, 6: 12.011, 7: 14.007, 8: 15.999, 9: 18.998,
         15: 30.974, 16: 32.06, 17: 35.45, 35: 79.904, 53: 126.904}
_OUTER = {1: 1, 6: 4, 7: 5, 8: 6, 9: 7, 15: 5, 16: 6, 17: 7, 35: 7, 53: 7}
_EN = {1: 2.20, 6: 2.55, 7: 3.04, 8: 3.44, 9: 3.98, 15: 2.19, 16: 2.58,
       17: 3.16, 35: 2.96, 53: 2.66}

class EspalomaError(RuntimeError):
    pass


@functools.lru_cache(maxsize=1)
def _graph() -> Graph:
    if not MODEL_PATH.is_file():
        raise EspalomaError(f"espaloma model not found at {MODEL_PATH}")
    return load_model(str(MODEL_PATH))


def _walk_graph(g: Graph, env: dict, matmul, relu, tanh, take):
    """Interpret the node list with the given primitive set (numpy arrays
    or torch tensors) -> (e, s)."""
    for node in g.nodes:
        ins = [env[i] for i in node.inputs]
        op = node.op_type
        if op == "MatMul":
            out = matmul(ins[0], ins[1])
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Relu":
            out = relu(ins[0])
        elif op == "Tanh":
            out = tanh(ins[0])
        elif op == "Gather":
            out = take(ins[0], ins[1], _gather_axis(node))
        else:
            raise EspalomaError(f"unsupported op {op}")
        env[node.outputs[0]] = out
    return env[g.outputs[0]], env[g.outputs[1]]


def _gather_axis(node) -> int:
    axis = node.attrs.get("axis")
    return axis.i if axis is not None and axis.i is not None else 0


def run_gnn(features: np.ndarray, adj_mean: np.ndarray):
    """Execute the parsed graph -> (e, s) per atom (numpy ground truth)."""
    g = _graph()
    env: dict[str, np.ndarray] = dict(g.initializers)
    env["features"] = features.astype(np.float32)
    env["adjacency_mean"] = adj_mean.astype(np.float32)
    e, s = _walk_graph(
        g, env,
        matmul=lambda a, b: a @ b,
        relu=lambda a: np.maximum(a, 0),
        tanh=np.tanh,
        take=lambda a, i, ax: np.take(a, i, axis=ax),
    )
    return np.asarray(e).reshape(-1), np.asarray(s).reshape(-1)


def _take(a: torch.Tensor, i: torch.Tensor, axis: int) -> torch.Tensor:
    """``np.take(a, i, axis)`` for a 0-d or 1-d index tensor on ``a``'s
    device (no host read of the index)."""
    out = torch.index_select(a, axis, i.reshape(-1))
    return out.squeeze(axis) if i.dim() == 0 else out


class EspalomaGNN(nn.Module):
    """The espaloma charge GNN: ``forward(features (n, 116), adj_mean (n,
    n)) -> (e (n,), s (n,))``, float32 on the module's device.

    The graph's initializers (ten weight matrices, two biases, the two
    Gather indices) are buffers under their ONNX names; the node list is
    the graph's, walked as :func:`run_gnn` walks it. Rows of a padded input
    whose features and adjacency are zero change no real row: a real row's
    ``adj @ h`` reads only real columns."""

    def __init__(self, graph: Graph, initializers: dict, device=None):
        super().__init__()
        self.graph = graph
        for name, value in initializers.items():
            self.register_buffer(name, torch.from_numpy(np.array(value)).to(device))

    @torch.no_grad()
    def forward(self, features: torch.Tensor, adj_mean: torch.Tensor):
        env = dict(self.named_buffers())
        env["features"] = features.to(FLOAT)
        env["adjacency_mean"] = adj_mean.to(FLOAT)
        e, s = _walk_graph(self.graph, env, matmul=torch.matmul, relu=torch.relu,
                           tanh=torch.tanh, take=_take)
        return e.reshape(-1), s.reshape(-1)


def load_gnn(device) -> EspalomaGNN:
    """The model of :data:`MODEL_PATH` on ``device``."""
    g = _graph()
    return EspalomaGNN(g, g.initializers, device=torch.device(device))


@functools.lru_cache(maxsize=None)
def _cached_gnn(device: torch.device) -> EspalomaGNN:
    return load_gnn(device)


# ---------------------------------------------------------------------------
# Featurization
# ---------------------------------------------------------------------------


def _hybridization(z, degree, n_double, n_triple, aromatic, neighbor_conj):
    if z == 1:
        return None
    if aromatic:
        return 1
    if degree >= 6:
        return 4
    if degree == 5:
        return 3
    if degree == 4:
        return 2
    if n_triple >= 1 or n_double >= 2:
        return 0
    if n_double == 1:
        return 1
    if neighbor_conj and ((z == 7 and degree == 3) or (z == 8 and degree <= 2)):
        return 1
    return 2


def _aromatic_atoms(z, fc, bonds, rings):
    n = len(z)
    inc: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for i, j, o in bonds:
        inc[i].append((j, o))
        inc[j].append((i, o))
    in_ring = np.zeros(n, dtype=bool)
    for r in rings:
        in_ring[r] = True

    contrib: list = []
    for a in range(n):
        sigma = len(inc[a])
        if sigma >= 4 or any(o == 3 and in_ring[j] for j, o in inc[a]):
            contrib.append(None)
            continue
        exocyclic_zero = False
        broken = False
        for j, o in inc[a]:
            if o >= 2 and not in_ring[j]:
                if _EN.get(int(z[j]), 0.0) > _EN.get(int(z[a]), 0.0):
                    exocyclic_zero = True
                else:
                    broken = True
                    break
        if broken:
            contrib.append(None)
            continue
        if exocyclic_zero:
            contrib.append(0)
            continue
        avail = _OUTER.get(int(z[a]), 0) - int(fc[a]) - sigma
        contrib.append(0 if avail <= 0 else (1 if avail % 2 == 1 else 2))

    def huckel(atoms):
        pi = 0
        for a in atoms:
            if contrib[a] is None:
                return False
            pi += contrib[a]
        return pi % 4 == 2

    arom = np.zeros(n, dtype=bool)
    for ring in rings:
        if huckel(ring):
            arom[ring] = True
    # Maximal fused systems (rings sharing >= 2 atoms), union-find.
    parent = list(range(len(rings)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            if len(set(rings[i]) & set(rings[j])) >= 2:
                parent[find(i)] = find(j)
    systems: dict[int, set] = {}
    for i in range(len(rings)):
        systems.setdefault(find(i), set()).update(rings[i])
    for atoms in systems.values():
        atoms = sorted(atoms)
        if huckel(atoms):
            arom[atoms] = True
    return arom


def featurize(z, fc, bonds):
    """(features [n,116], adjacency_mean [n,n]) per charge.rs:213-290."""
    n = len(z)
    rings = sssr_rings(n, np.asarray([(i, j) for i, j, _ in bonds]).reshape(-1, 2))
    rg = np.zeros((n, 11), dtype=bool)
    for r in rings:
        sz = min(len(r), 10)
        rg[r, sz] = True
    nd = np.zeros(n, np.int64)
    nt = np.zeros(n, np.int64)
    val = np.zeros(n, np.int64)
    deg = np.zeros(n, np.int64)
    for i, j, o in bonds:
        val[i] += o
        val[j] += o
        deg[i] += 1
        deg[j] += 1
        if o == 2:
            nd[i] += 1
            nd[j] += 1
        elif o == 3:
            nt[i] += 1
            nt[j] += 1
    aromatic = _aromatic_atoms(z, fc, bonds, rings)
    adjlist: list[list[int]] = [[] for _ in range(n)]
    for i, j, _ in bonds:
        adjlist[i].append(j)
        adjlist[j].append(i)
    neighbor_conj = np.array(
        [
            any(
                aromatic[j] or ((nd[j] > 0 or nt[j] > 0) and int(z[j]) in (6, 7))
                for j in adjlist[i]
            )
            for i in range(n)
        ]
    )
    feat = np.zeros((n, 116), dtype=np.float32)
    for i in range(n):
        zi = int(z[i])
        if zi < 100:
            feat[i, zi] = 1.0
        feat[i, 100] = deg[i]
        feat[i, 101] = val[i]
        feat[i, 102] = val[i]
        feat[i, 103] = 1.0 if aromatic[i] else 0.0
        feat[i, 104] = _MASS.get(zi, 0.0)
        for k, sz in enumerate(range(3, 9)):
            feat[i, 105 + k] = 1.0 if rg[i, sz] else 0.0
        h = _hybridization(zi, int(deg[i]), int(nd[i]), int(nt[i]),
                           bool(aromatic[i]), bool(neighbor_conj[i]))
        if h is not None:
            feat[i, 111 + h] = 1.0
    adj = np.zeros((n, n), dtype=np.float32)
    for i, j, _ in bonds:
        adj[i, j] = 1.0
        adj[j, i] = 1.0
    rowsum = adj.sum(axis=1, keepdims=True)
    adj = np.divide(adj, rowsum, out=adj, where=rowsum > 0)
    return feat, adj


def equilibrate(e: np.ndarray, s: np.ndarray) -> np.ndarray:
    """q_i = -e_i/s_i + (1/s_i) (sum e/s)/(sum 1/s); total charge 0."""
    inv = 1.0 / s
    lam = float((e * inv).sum() / inv.sum())
    return -e * inv + inv * lam


def _use_torch() -> bool:
    """``MOLAR_ESPALOMA_BACKEND``: ``numpy`` takes the host walk; ``torch``
    and ``auto`` (the default) take the torch forward (the port is a torch
    process, so ``auto`` always does)."""
    return os.environ.get("MOLAR_ESPALOMA_BACKEND", "auto") != "numpy"


def run_gnn_torch(features: np.ndarray, adj_mean: np.ndarray, device=None):
    """:class:`EspalomaGNN` on ``device`` (None: the card) -> numpy (e, s)."""
    dev = resolve_device(device)
    gnn = _cached_gnn(dev)
    e, s = gnn(torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev),
               torch.from_numpy(np.ascontiguousarray(adj_mean, np.float32)).to(dev))
    return e.cpu().numpy(), s.cpu().numpy()


def espaloma_charges(z, fc, bonds, device=None) -> np.ndarray:
    """Charges of one molecule: ``z`` atomic numbers, ``fc`` formal charges,
    ``bonds`` ``(i, j, order)`` triples. The forward runs on ``device``
    (None: the card; no CUDA device raises) unless
    ``MOLAR_ESPALOMA_BACKEND=numpy``."""
    feat, adj = featurize(z, fc, bonds)
    if _use_torch():
        e, s = run_gnn_torch(feat, adj, device)
    else:
        e, s = run_gnn(feat, adj)
    return equilibrate(e, s)


def apply_charges(sel_or_system, indices=None, device=None) -> np.ndarray:
    """Compute espaloma charges and write the charge column (reference
    SystemPy.apply_charges): of a :class:`~molar_tpu_torch.core.system.Sel`,
    of a whole :class:`~molar_tpu_torch.core.system.System`, or of the atoms
    ``indices`` of a System (e.g. from ``System.select_indices``). Bond
    orders and formal charges come from the topology's columns (order 1 and
    charge 0 where a column is absent, an order 0 counting as 1); bonds with
    an atom outside the selection are dropped. The forward runs on
    ``device`` (None: the card)."""
    from ..core.system import Sel

    if isinstance(sel_or_system, Sel):
        if indices is not None:
            raise ValueError("indices are taken from the Sel; pass a System with indices")
        idx = sel_or_system.indices
    else:
        idx = (np.arange(sel_or_system.topology.n_atoms) if indices is None
               else np.asarray(indices, np.int64).reshape(-1))
    top = sel_or_system.topology
    local = {int(g): k for k, g in enumerate(idx)}
    fc = (top.formal_charge[idx] if top.formal_charge is not None
          else np.zeros(len(idx), np.int64))
    orders = top.bond_orders
    in_sel = np.zeros(top.n_atoms, dtype=bool)
    in_sel[idx] = True
    bonds = []
    for bi in range(top.n_bonds):
        a, b = int(top.bonds[bi, 0]), int(top.bonds[bi, 1])
        if in_sel[a] and in_sel[b]:
            o = int(orders[bi]) if orders is not None else 1
            bonds.append((local[a], local[b], max(o, 1)))
    q = espaloma_charges(top.atomic_number[idx], fc, bonds, device=device)
    top.charge[idx] = q.astype(top.charge.dtype)
    return q
