"""Host evaluator for selection ASTs: vectorized numpy over topology columns.

Subset semantics mirror the reference evaluator (molar/src/selection/ast.rs):

* every node's result is constrained to the *current* subset;
* ``and`` evaluates its RHS inside the LHS result subset (ast.rs:539-556);
* ``not`` complements against the current subset (ast.rs:513-521 — note the
  code uses the current subset, despite its comment saying "global");
* ``same ... as`` maps the inner result's attribute values over the *global*
  subset (ast.rs:437-460);
* ``within``'s inner expression evaluates in the *global* subset; the outer
  search domain is the current subset; ``self`` appends the inner result
  (ast.rs:589-635);
* ``all`` yields the global subset.

Instead of per-node index vectors, nodes evaluate to boolean masks over all N
atoms (constrained to the subset mask) — the numpy-native form of the same
algebra, and exactly what ships to the device for jit re-evaluation.

Caching: coordinate-independent (state-independent) subtree results are cached
on the evaluator per node id, playing the role of the reference's
``Precomputed`` AST mutation (ast.rs:505-530). Cached masks are
*subset-independent* full-predicate masks intersected with the subset at use;
this diverges from the reference's cache-in-first-subset behavior only in
cases where the reference would return stale results (dynamic LHS `and`
static RHS across frames).

The port's own copy of ``molar_tpu.selection.evaluator`` (numpy only; the port imports
nothing of the JAX package), held equal to it by behaviour in
``tests/test_torch_selection.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.pbc import PBC_NONE, PbcDims
from ..core.periodic_table import ELEMENT_VDW_NM, NUM_ELEMENTS
from ..ops import neighbor_host
from . import nodes as N


class SelectionEvalError(RuntimeError):
    pass


PROTEIN_RESNAMES = frozenset(
    """GLY ALA VAL PHE PRO MET ILE LEU ASP GLU LYS ARG SER THR TYR
       HIS CYS ASN GLN TRP HSE HSD HSP CYX""".split()
)
BACKBONE_NAMES = frozenset(("C", "N", "O", "CA"))
WATER_RESNAMES = frozenset(("SOL", "HOH", "TIP3", "TIP4", "TIP5", "OPC"))
ELECTRONEGATIVE_Z = (7, 8, 9, 16)


class EvalContext:
    """One evaluation pass over a (topology, state) pair."""

    def __init__(self, topology, state, global_subset: Optional[np.ndarray] = None):
        self.top = topology
        self.state = state
        n = topology.n_atoms
        if global_subset is None:
            g = np.ones(n, dtype=bool)
        else:
            g = np.zeros(n, dtype=bool)
            g[global_subset] = True
        self.global_mask = g
        self._static_cache: dict[int, np.ndarray] = {}
        self._pred_cache: dict[int, np.ndarray] = {}

    # -- column helpers -----------------------------------------------------

    def _hydrogen_mask(self) -> np.ndarray:
        key = ("hydrogen",)
        cached = self._pred_cache.get(key)
        if cached is None:
            # First alphabetic char of the *name* is 'H' (ast.rs:712-719).
            cached = np.fromiter(
                (_first_alpha_is_h(s) for s in self.top.name_pool.strings),
                dtype=bool,
                count=len(self.top.name_pool),
            )[self.top.name]
            self._pred_cache[key] = cached
        return cached

    def resname_in(self, values) -> np.ndarray:
        codes = self.top.resname_pool.codes_matching(values)
        return np.isin(self.top.resname, codes)

    def name_in(self, values) -> np.ndarray:
        codes = self.top.name_pool.codes_matching(values)
        return np.isin(self.top.name, codes)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, node: N.Logical) -> np.ndarray:
        """Global sorted index array of the selection result."""
        mask = self.eval_mask(node, self.global_mask)
        return np.nonzero(mask)[0]

    def eval_mask(self, node: N.Logical, cur: np.ndarray) -> np.ndarray:
        nid = id(node)
        if not N.is_state_dependent(node):
            full = self._static_cache.get(nid)
            if full is None:
                full = self._eval_pred(node, self.global_mask)
                self._static_cache[nid] = full
            return full & cur
        return self._eval_pred(node, cur)

    def _eval_pred(self, node: N.Logical, cur: np.ndarray) -> np.ndarray:
        if isinstance(node, N.LAll):
            return self.global_mask & cur
        if isinstance(node, N.LAnd):
            a = self.eval_mask(node.left, cur)
            b = self.eval_mask(node.right, a)
            return a & b
        if isinstance(node, N.LOr):
            return self.eval_mask(node.left, cur) | self.eval_mask(node.right, cur)
        if isinstance(node, N.LNot):
            return cur & ~self.eval_mask(node.operand, cur)
        if isinstance(node, N.LSame):
            inner = self.eval_mask(node.inner, cur)
            if node.attr is N.SameAttr.RESIDUE:
                col = self.top.resindex
            else:
                col = self.top.chain
            props = np.unique(col[inner])
            return self.global_mask & np.isin(col, props)
        if isinstance(node, N.LKeyword):
            return self._eval_keyword(node.keyword) & cur
        if isinstance(node, N.LChemical):
            return self._eval_chemical(node.chemical) & cur
        if isinstance(node, N.LComparison):
            return self._eval_comparison(node.comparison, cur)
        if isinstance(node, N.LWithin):
            inner_mask = self.eval_mask(node.inner, self.global_mask)
            return self._within(node.params, np.nonzero(inner_mask)[0], cur, inner_mask)
        if isinstance(node, N.LWithinPoint):
            point = self.eval_vector(node.point)
            return self._within(node.params, point, self.global_mask, None)
        raise TypeError(type(node))

    # -- keywords -------------------------------------------------------------

    def _eval_keyword(self, kw: N.Keyword) -> np.ndarray:
        kind = kw.kind
        if kind in (N.KeywordKind.NAME, N.KeywordKind.RESNAME):
            pool = self.top.name_pool if kind is N.KeywordKind.NAME else self.top.resname_pool
            codes_col = self.top.name if kind is N.KeywordKind.NAME else self.top.resname
            matched: set[int] = set()
            for arg in kw.args:
                if isinstance(arg, N.StrArg):
                    c = pool.codes_equal(arg.value)
                    if c >= 0:
                        matched.add(c)
                else:
                    matched.update(pool.codes_matching_regex(arg.pattern).tolist())
            return np.isin(codes_col, np.fromiter(matched, dtype=np.int32, count=len(matched)))
        if kind is N.KeywordKind.CHAIN:
            vals = np.array([a.value for a in kw.args], dtype="U1")
            return np.isin(self.top.chain, vals)
        # int keywords
        if kind is N.KeywordKind.RESID:
            col = self.top.resid
        elif kind is N.KeywordKind.RESINDEX:
            col = self.top.resindex
        else:  # INDEX
            col = np.arange(self.top.n_atoms)
        mask = np.zeros(self.top.n_atoms, dtype=bool)
        singles = [a.value for a in kw.args if isinstance(a, N.IntArg)]
        if singles:
            mask |= np.isin(col, np.asarray(singles, dtype=col.dtype))
        for a in kw.args:
            if isinstance(a, N.IntRangeArg):
                mask |= (col >= a.lo) & (col <= a.hi)
        return mask

    # -- chemical compounds ----------------------------------------------------

    def _eval_chemical(self, chem: N.Chemical) -> np.ndarray:
        C = N.Chemical
        if chem is C.PROTEIN:
            return self.resname_in(PROTEIN_RESNAMES)
        if chem is C.BACKBONE:
            return self.resname_in(PROTEIN_RESNAMES) & self.name_in(BACKBONE_NAMES)
        if chem is C.SIDECHAIN:
            return self.resname_in(PROTEIN_RESNAMES) & ~self.name_in(BACKBONE_NAMES)
        if chem is C.WATER:
            return self.resname_in(WATER_RESNAMES)
        if chem is C.NOT_WATER:
            return ~self.resname_in(WATER_RESNAMES)
        if chem is C.HYDROGEN:
            return self._hydrogen_mask()
        if chem is C.NOT_HYDROGEN:
            return ~self._hydrogen_mask()
        if chem in (C.POLAR_H, C.APOLAR_H):
            return self._hydrogens_by_polarity(chem is C.POLAR_H)
        raise TypeError(chem)

    def _hydrogens_by_polarity(self, want_polar: bool) -> np.ndarray:
        """polh/apolh from the bond graph (ast.rs:720-760); empty when no
        bonds exist."""
        mask = np.zeros(self.top.n_atoms, dtype=bool)
        bonds = self.top.bonds
        if bonds.shape[0] == 0:
            return mask
        is_h = self._hydrogen_mask()
        z = self.top.atomic_number
        polar = np.isin(z, ELECTRONEGATIVE_Z) & ~is_h
        apolar = ~polar & ~is_h
        partner = polar if want_polar else apolar
        i, j = bonds[:, 0], bonds[:, 1]
        mask[i[is_h[i] & partner[j]]] = True
        mask[j[is_h[j] & partner[i]]] = True
        return mask

    # -- comparisons -------------------------------------------------------------

    def _eval_comparison(self, cmp_: N.Comparison, cur: np.ndarray) -> np.ndarray:
        vals = [self.eval_math(t, cur) for t in cmp_.terms]
        ops = {
            "<": np.less,
            "<=": np.less_equal,
            ">": np.greater,
            ">=": np.greater_equal,
            "==": np.equal,
            "!=": np.not_equal,
        }
        mask = ops[cmp_.ops[0]](vals[0], vals[1])
        if len(cmp_.ops) == 2:
            mask &= ops[cmp_.ops[1]](vals[1], vals[2])
        return mask & cur

    def eval_math(self, e: N.MathExpr, cur: np.ndarray) -> np.ndarray:
        """(N,) float array; runtime errors (div by zero, sqrt of negative,
        missing velocities/forces) only trigger for atoms in ``cur``."""
        if isinstance(e, N.MathConst):
            return np.full(self.top.n_atoms, e.value)
        if isinstance(e, N.MathAttr):
            return self._math_attr(e.var)
        if isinstance(e, N.MathComponentOf):
            v = self.eval_vector(e.vector)
            return np.full(self.top.n_atoms, v[e.axis])
        if isinstance(e, N.MathBinary):
            a = self.eval_math(e.left, cur)
            b = self.eval_math(e.right, cur)
            if e.op == "+":
                return a + b
            if e.op == "-":
                return a - b
            if e.op == "*":
                return a * b
            if e.op == "^":
                with np.errstate(invalid="ignore"):
                    return np.power(a, b)
            if e.op == "/":
                if np.any(b[cur] == 0.0):
                    raise SelectionEvalError("division by zero in selection math")
                with np.errstate(divide="ignore", invalid="ignore"):
                    return a / b
            raise TypeError(e.op)
        if isinstance(e, N.MathNeg):
            return -self.eval_math(e.operand, cur)
        if isinstance(e, N.MathFunc):
            v = self.eval_math(e.operand, cur)
            if e.name == "abs":
                return np.abs(v)
            if e.name == "sqrt":
                if np.any(v[cur] < 0.0):
                    raise SelectionEvalError("sqrt of negative value in selection math")
                with np.errstate(invalid="ignore"):
                    return np.sqrt(v)
            if e.name == "sin":
                return np.sin(v)
            if e.name == "cos":
                return np.cos(v)
            raise TypeError(e.name)
        if isinstance(e, N.MathDist):
            return self._eval_dist(e.dist)
        raise TypeError(type(e))

    def _math_attr(self, var: N.MathVar) -> np.ndarray:
        V = N.MathVar
        st, top = self.state, self.top
        if var in (V.X, V.Y, V.Z):
            return st.coords[:, (V.X, V.Y, V.Z).index(var)]
        if var in (V.VX, V.VY, V.VZ):
            if st.velocities is None:
                raise SelectionEvalError("selection uses velocities but state has none")
            return st.velocities[:, (V.VX, V.VY, V.VZ).index(var)]
        if var in (V.FX, V.FY, V.FZ):
            if st.forces is None:
                raise SelectionEvalError("selection uses forces but state has none")
            return st.forces[:, (V.FX, V.FY, V.FZ).index(var)]
        if var is V.MASS:
            return top.mass
        if var is V.CHARGE:
            return top.charge
        if var is V.VDW:
            z = np.clip(top.atomic_number, 0, NUM_ELEMENTS - 1)
            return ELEMENT_VDW_NM[z]
        if var is V.OCCUPANCY:
            return top.occupancy
        if var is V.BFACTOR:
            return top.bfactor
        if var is V.RESID:
            return top.resid.astype(np.float64)
        if var is V.RESINDEX:
            return top.resindex.astype(np.float64)
        if var is V.INDEX:
            return np.arange(top.n_atoms, dtype=np.float64)
        raise TypeError(var)

    # -- vectors ------------------------------------------------------------------

    def eval_vector(self, v: N.VectorExpr) -> np.ndarray:
        if isinstance(v, N.VecConst):
            return np.asarray(v.value, dtype=np.float64)
        if isinstance(v, (N.VecCom, N.VecCog)):
            idx = np.nonzero(self.eval_mask(v.inner, self.global_mask))[0]
            if len(idx) == 0:
                raise SelectionEvalError("com/cog of empty selection")
            from ..ops import measure_host

            weights = self.top.mass[idx] if isinstance(v, N.VecCom) else None
            if v.pbc == PBC_NONE:
                return measure_host.center(self.state.coords[idx], weights)
            return measure_host.center_pbc(
                self.state.coords[idx], weights, self.state.require_box(), v.pbc
            )
        if isinstance(v, N.VecNthAtom):
            idx = np.nonzero(self.eval_mask(v.inner, self.global_mask))[0]
            if v.n >= len(idx):
                raise SelectionEvalError(
                    f"pos {v.n} of selection with {len(idx)} atoms is out of bounds"
                )
            return self.state.coords[idx[v.n]].astype(np.float64)
        raise TypeError(type(v))

    # -- distances -----------------------------------------------------------------

    def _unit(self, v: N.VectorExpr) -> np.ndarray:
        vec = self.eval_vector(v)
        n = np.linalg.norm(vec)
        if n == 0:
            raise SelectionEvalError("zero-length direction vector")
        return vec / n

    def _eval_dist(self, d: N.DistanceExpr) -> np.ndarray:
        coords = self.state.coords.astype(np.float64)
        pbc = d.pbc
        # The reference first moves each atom to its closest image relative to
        # the node's anchor point (ast.rs Dist eval: "Point should be
        # unwrapped first").
        if isinstance(d, N.DistPoint):
            anchor = self.eval_vector(d.point)
        elif isinstance(d, (N.DistLine, N.DistPlane)):
            anchor = self.eval_vector(d.p1)
        else:
            anchor = self.eval_vector(d.point)
        if self.state.box is not None and pbc.any:
            box = self.state.box
            pos = anchor + box.shortest_vector(coords - anchor, pbc).astype(np.float64)
        else:
            pos = coords
        if isinstance(d, N.DistPoint):
            return np.linalg.norm(pos - anchor, axis=1)
        if isinstance(d, N.DistLine):
            p1 = self.eval_vector(d.p1)
            p2 = self.eval_vector(d.p2)
            v = p2 - p1
            w = pos - p1
            proj = (w @ v) / (v @ v)
            return np.linalg.norm(w - proj[:, None] * v, axis=1)
        if isinstance(d, N.DistLineDir):
            u = self._unit(d.direction)
            w = pos - self.eval_vector(d.point)
            proj = w @ u
            return np.linalg.norm(w - proj[:, None] * u, axis=1)
        if isinstance(d, N.DistPlane):
            p1 = self.eval_vector(d.p1)
            nrm = np.cross(
                self.eval_vector(d.p2) - p1, self.eval_vector(d.p3) - p1
            )
            w = pos - p1
            return np.abs(w @ nrm) / np.linalg.norm(nrm)
        if isinstance(d, N.DistPlaneNormal):
            u = self._unit(d.normal)
            w = pos - self.eval_vector(d.point)
            return np.abs(w @ u)
        raise TypeError(type(d))

    # -- within ---------------------------------------------------------------------

    def _within(
        self,
        params: N.WithinParams,
        target,
        cur: np.ndarray,
        inner_mask: Optional[np.ndarray],
    ) -> np.ndarray:
        src_idx = np.nonzero(cur)[0]
        box = self.state.box if params.pbc.any else None
        if params.pbc.any and self.state.box is None:
            raise SelectionEvalError("pbc within requires a periodic box")
        found = neighbor_host.search_within(
            params.cutoff, self.state.coords, src_idx, target, box, params.pbc
        )
        mask = np.zeros(self.top.n_atoms, dtype=bool)
        mask[found] = True
        if params.include_inner and inner_mask is not None:
            mask |= inner_mask
        return mask


def _first_alpha_is_h(name: str) -> bool:
    for c in name:
        if c.isalpha():
            return c == "H"
    return False
