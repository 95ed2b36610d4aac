"""Selection AST node types.

Mirrors the reference node taxonomy (molar/src/selection/ast.rs:11-186):
logical nodes (and/or/not/same/within/keyword/comparison/chemical/all), keyword
nodes over int/str/chain columns, a math expression tree, vector nodes
(const / com / cog / pos-of), and distance nodes (point/line/plane).

Nodes are plain dataclasses; evaluation lives in
:mod:`molar_tpu.selection.evaluator` (host, vectorized numpy) and in
:mod:`molar_tpu.selection.compiled` (jax mask functions for state-dependent
selections re-evaluated per frame on device).

The port's own copy of ``molar_tpu.selection.nodes`` (numpy only; the port imports
nothing of the JAX package), held equal to it by behaviour in
``tests/test_torch_selection.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np

from ..core.pbc import PbcDims


# -- keyword arguments ---------------------------------------------------------


@dataclass(frozen=True)
class IntArg:
    value: int


@dataclass(frozen=True)
class IntRangeArg:
    lo: int
    hi: int  # inclusive


@dataclass(frozen=True)
class StrArg:
    value: str


@dataclass(frozen=True)
class RegexArg:
    pattern: str  # anchored at match time (^...$)


IntKeywordArg = Union[IntArg, IntRangeArg]
StrKeywordArg = Union[StrArg, RegexArg]


class KeywordKind(enum.Enum):
    NAME = "name"
    RESNAME = "resname"
    RESID = "resid"
    RESINDEX = "resindex"
    INDEX = "index"
    CHAIN = "chain"


@dataclass
class Keyword:
    kind: KeywordKind
    args: list


# -- math ----------------------------------------------------------------------


class MathVar(enum.Enum):
    X = "x"
    Y = "y"
    Z = "z"
    VX = "vx"
    VY = "vy"
    VZ = "vz"
    FX = "fx"
    FY = "fy"
    FZ = "fz"
    MASS = "mass"
    CHARGE = "charge"
    VDW = "vdw"
    OCCUPANCY = "occupancy"
    BFACTOR = "bfactor"
    # int atom attributes usable in comparisons ("10 < resid < 20" — the
    # reference README's Numeric-comparisons contract; its own peg grammar
    # omits them, a documented-but-unimplemented promise we honor)
    RESID = "resid"
    RESINDEX = "resindex"
    INDEX = "index"


@dataclass
class MathConst:
    value: float


@dataclass
class MathAttr:
    var: MathVar


@dataclass
class MathComponentOf:
    """x/y/z of <vector>."""

    axis: int  # 0, 1, 2
    vector: "VectorExpr"


@dataclass
class MathBinary:
    op: str  # + - * / ^
    left: "MathExpr"
    right: "MathExpr"


@dataclass
class MathNeg:
    operand: "MathExpr"


@dataclass
class MathFunc:
    name: str  # abs sqrt sin cos
    operand: "MathExpr"


@dataclass
class MathDist:
    dist: "DistanceExpr"


MathExpr = Union[MathConst, MathAttr, MathComponentOf, MathBinary, MathNeg, MathFunc, MathDist]


# -- vectors -------------------------------------------------------------------


@dataclass
class VecConst:
    value: np.ndarray  # (3,)


@dataclass
class VecCom:
    inner: "Logical"
    pbc: PbcDims


@dataclass
class VecCog:
    inner: "Logical"
    pbc: PbcDims


@dataclass
class VecNthAtom:
    """``pos N of SEL`` — position of the N-th atom of the inner selection.

    Divergence note: the reference reads the N-th atom of the *evaluation
    context* instead of the inner result (ast.rs:404-411, an apparent bug);
    we implement the documented intent.
    """

    inner: "Logical"
    n: int


VectorExpr = Union[VecConst, VecCom, VecCog, VecNthAtom]


# -- distances -----------------------------------------------------------------


@dataclass
class DistPoint:
    point: VectorExpr
    pbc: PbcDims


@dataclass
class DistLine:
    p1: VectorExpr
    p2: VectorExpr
    pbc: PbcDims


@dataclass
class DistLineDir:
    point: VectorExpr
    direction: VectorExpr
    pbc: PbcDims


@dataclass
class DistPlane:
    p1: VectorExpr
    p2: VectorExpr
    p3: VectorExpr
    pbc: PbcDims


@dataclass
class DistPlaneNormal:
    point: VectorExpr
    normal: VectorExpr
    pbc: PbcDims


DistanceExpr = Union[DistPoint, DistLine, DistLineDir, DistPlane, DistPlaneNormal]


# -- comparisons ---------------------------------------------------------------


@dataclass
class Comparison:
    """Simple ``a OP b`` or chained ``a OP1 b OP2 c`` (ops: < <= > >= == !=;
    chained only with both ops from {<,<=} or both from {>,>=})."""

    terms: list  # 2 or 3 MathExpr
    ops: list  # 1 or 2 op strings


# -- chemical compounds --------------------------------------------------------


class Chemical(enum.Enum):
    PROTEIN = "protein"
    BACKBONE = "backbone"
    SIDECHAIN = "sidechain"
    WATER = "water"
    NOT_WATER = "now"
    HYDROGEN = "hydrogen"
    NOT_HYDROGEN = "noh"
    POLAR_H = "polh"
    APOLAR_H = "apolh"


# -- logical -------------------------------------------------------------------


@dataclass
class WithinParams:
    cutoff: float
    pbc: PbcDims
    include_inner: bool


@dataclass
class LAnd:
    left: "Logical"
    right: "Logical"


@dataclass
class LOr:
    left: "Logical"
    right: "Logical"


@dataclass
class LNot:
    operand: "Logical"


class SameAttr(enum.Enum):
    RESIDUE = "residue"
    CHAIN = "chain"


@dataclass
class LSame:
    attr: SameAttr
    inner: "Logical"


@dataclass
class LWithin:
    params: WithinParams
    inner: "Logical"


@dataclass
class LWithinPoint:
    params: WithinParams
    point: VectorExpr


@dataclass
class LKeyword:
    keyword: Keyword


@dataclass
class LComparison:
    comparison: Comparison


@dataclass
class LChemical:
    chemical: Chemical


@dataclass
class LAll:
    pass


Logical = Union[
    LAnd, LOr, LNot, LSame, LWithin, LWithinPoint, LKeyword, LComparison, LChemical, LAll
]


# -- state dependence ----------------------------------------------------------


def math_is_state_dependent(e: MathExpr) -> bool:
    if isinstance(e, MathConst):
        return False
    if isinstance(e, MathAttr):
        return e.var in (
            MathVar.X,
            MathVar.Y,
            MathVar.Z,
            MathVar.VX,
            MathVar.VY,
            MathVar.VZ,
            MathVar.FX,
            MathVar.FY,
            MathVar.FZ,
        )
    if isinstance(e, MathComponentOf):
        return vector_is_state_dependent(e.vector)
    if isinstance(e, MathBinary):
        return math_is_state_dependent(e.left) or math_is_state_dependent(e.right)
    if isinstance(e, (MathNeg, MathFunc)):
        return math_is_state_dependent(e.operand)
    if isinstance(e, MathDist):
        return True
    raise TypeError(type(e))


def vector_is_state_dependent(v: VectorExpr) -> bool:
    """COM/COG/pos-of read coordinates, so they are always state-dependent.

    Divergence note: the reference reports only the *inner selection's*
    dependence and freezes the computed vector after the first evaluation
    (ast.rs:382-411), so e.g. ``dist point com of protein`` keeps frame 1's
    COM on later frames. We recompute per evaluation.
    """
    if isinstance(v, VecConst):
        return False
    return True


def is_state_dependent(n: Logical) -> bool:
    if isinstance(n, (LAll, LChemical, LKeyword)):
        return False
    if isinstance(n, (LWithin, LWithinPoint)):
        return True
    if isinstance(n, (LNot, LSame)):
        return is_state_dependent(n.operand if isinstance(n, LNot) else n.inner)
    if isinstance(n, (LAnd, LOr)):
        # Divergence note: reference uses `&&` here (ast.rs:497), which
        # under-reports mixed static/dynamic junctions; `or` is correct.
        return is_state_dependent(n.left) or is_state_dependent(n.right)
    if isinstance(n, LComparison):
        return any(math_is_state_dependent(t) for t in n.comparison.terms)
    raise TypeError(type(n))
