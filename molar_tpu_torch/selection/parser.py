"""Recursive-descent parser for the selection language.

Hand-rolled PEG-style parser (ordered choice + backtracking) reproducing the
reference grammar (molar/src/selection/grammar.rs:9-378):

* keywords: ``name resname resid resindex index chain`` with values, int
  ranges ``a:b``, quoted-free strings and ``/regex/`` values (anchored);
* compounds: ``protein backbone sidechain water now hydrogen noh polh apolh``;
* math over ``x y z vx vy vz fx fy fz mass charge vdw occupancy|occ
  bfactor|beta`` with ``+ - * / ^``, ``abs sqrt sin cos``, distance
  expressions ``dist [pbc] point|line|plane ...``;
* simple and chained comparisons;
* ``same residue|chain as``, ``within CUTOFF [pbc [DDD]|nopbc] [self] of``;
* vector values: ``X Y Z``, ``[x,y,z]``, ``com|cog [pbc] of SEL``,
  ``pos N of SEL``;
* ``and``/``or`` at the SAME precedence level, left-associative (grammar.rs
  precedence! block), ``not``/``same``/``within`` prefixes binding tighter;
* bareword keywords require a word boundary (grammar.rs:18-22).

Divergence note: the reference's ``vec3_cog`` rule spells "com" (grammar.rs:134),
making ``cog of`` unreachable; here ``cog of`` parses as center of geometry.

Syntax errors carry the offset and a curated expected-token set
(reference SyntaxError, ast.rs:1250).

The port's own copy of ``molar_tpu.selection.parser`` (numpy only; the port imports
nothing of the JAX package), held equal to it by behaviour in
``tests/test_torch_selection.py``.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, TypeVar

import numpy as np

from ..core.pbc import PBC_FULL, PBC_NONE, PbcDims
from . import nodes as N

T = TypeVar("T")

_WORD_CHAR = re.compile(r"[A-Za-z0-9_]")
_FLOAT_RE = re.compile(r"([-+]?\d+(\.\d+)?|[-+]?\.\d+)([eE][-+]?\d+)?")
_INT_RE = re.compile(r"[-+]?\d+")
_UINT_RE = re.compile(r"\d+")
_STR_VALUE_RE = re.compile(r"[^ \t/()<>=!&|,]+")
_CMP_OPS = ("==", "!=", "<=", "<", ">=", ">")


class SelectionSyntaxError(ValueError):
    def __init__(self, input_str: str, offset: int, expected: list[str]):
        self.input = input_str
        self.offset = offset
        self.expected = sorted(set(expected))
        caret = " " * offset + "^"
        exp = ", ".join(self.expected) if self.expected else "end of input"
        super().__init__(
            f"selection syntax error at offset {offset}:\n{input_str}\n{caret}\nexpected: {exp}"
        )


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.n = len(text)
        # Farthest failure tracking for error messages.
        self.fail_pos = 0
        self.fail_expected: list[str] = []

    # -- primitives ---------------------------------------------------------

    def _fail(self, pos: int, expected: str):
        if pos > self.fail_pos:
            self.fail_pos = pos
            self.fail_expected = [expected]
        elif pos == self.fail_pos:
            self.fail_expected.append(expected)
        return None

    def ws(self, pos: int) -> int:
        while pos < self.n and self.text[pos] in " \t":
            pos += 1
        return pos

    def ws1(self, pos: int) -> Optional[int]:
        """Mandatory whitespace."""
        p = self.ws(pos)
        if p == pos:
            return self._fail(pos, "whitespace")
        return p

    def ws1_or_paren(self, pos: int) -> Optional[int]:
        """Mandatory whitespace unless followed by '(' (grammar rule ___)."""
        p = self.ws(pos)
        if p < self.n and self.text[p] == "(":
            return p
        if p == pos:
            return self._fail(pos, "whitespace")
        return p

    def lit(self, pos: int, s: str) -> Optional[int]:
        if self.text.startswith(s, pos):
            return pos + len(s)
        return self._fail(pos, repr(s))

    def word(self, pos: int, s: str) -> Optional[int]:
        """Literal with a word boundary after it."""
        if self.text.startswith(s, pos):
            end = pos + len(s)
            if end >= self.n or not _WORD_CHAR.match(self.text[end]):
                return end
        return self._fail(pos, s)

    def rx(self, pos: int, pattern: re.Pattern, what: str):
        m = pattern.match(self.text, pos)
        if m:
            return m.group(0), m.end()
        return self._fail(pos, what), pos

    # -- numbers ------------------------------------------------------------

    def p_float(self, pos: int):
        s, p = self.rx(pos, _FLOAT_RE, "number")
        if s is None:
            return None, pos
        return float(s), p

    def p_int(self, pos: int):
        s, p = self.rx(pos, _INT_RE, "integer")
        if s is None:
            return None, pos
        return int(s), p

    def p_uint(self, pos: int):
        s, p = self.rx(pos, _UINT_RE, "unsigned integer")
        if s is None:
            return None, pos
        return int(s), p

    # -- keyword expressions -------------------------------------------------

    def p_int_keyword(self, pos: int):
        for kw, kind in (
            ("resid", N.KeywordKind.RESID),
            ("resindex", N.KeywordKind.RESINDEX),
            ("index", N.KeywordKind.INDEX),
        ):
            p = self.lit(pos, kw)
            if p is None:
                continue
            p1 = self.ws1(p)
            if p1 is None:
                continue
            args, p2 = self.p_int_args(p1)
            if args:
                return N.Keyword(kind, args), p2
        return None, pos

    def p_int_args(self, pos: int):
        args = []
        p = pos
        while True:
            a, p2 = self.p_int_arg(p)
            if a is None:
                break
            args.append(a)
            p = p2
            p3 = self.ws1(p)
            if p3 is None:
                break
            # Only advance past the whitespace if another arg follows.
            a2_probe, _ = self.p_int_arg(p3)
            if a2_probe is None:
                break
            p = p3
        return args, p

    def p_int_arg(self, pos: int):
        i1, p = self.p_int(pos)
        if i1 is None:
            return None, pos
        p2 = self.ws(p)
        p3 = self.lit(p2, ":")
        if p3 is not None:
            p3 = self.ws(p3)
            i2, p4 = self.p_int(p3)
            if i2 is not None:
                return N.IntRangeArg(i1, i2), p4
        return N.IntArg(i1), p

    def p_str_keyword(self, pos: int):
        for kw, kind in (("name", N.KeywordKind.NAME), ("resname", N.KeywordKind.RESNAME)):
            p = self.lit(pos, kw)
            if p is None:
                continue
            p1 = self.ws1(p)
            if p1 is None:
                continue
            args, p2 = self.p_str_args(p1)
            if args:
                return N.Keyword(kind, args), p2
        return None, pos

    def p_str_args(self, pos: int):
        args = []
        p = pos
        while True:
            a, p2 = self.p_str_arg(p)
            if a is None:
                break
            args.append(a)
            p = p2
            p3 = self.ws1(p)
            if p3 is None:
                break
            probe, _ = self.p_str_arg(p3)
            if probe is None:
                break
            p = p3
        return args, p

    def p_str_arg(self, pos: int):
        # regex value: /.../
        if pos < self.n and self.text[pos] == "/":
            end = self.text.find("/", pos + 1)
            if end > pos + 1:
                pat = self.text[pos + 1 : end]
                try:
                    re.compile(pat)
                except re.error:
                    return self._fail(pos, "valid regex"), pos
                return N.RegexArg(pat), end + 1
            return self._fail(pos, "closing '/'"), pos
        # bareword value, but not and/or
        for op in ("and", "or"):
            p = self.word(pos, op)
            if p is not None:
                return None, pos
        s, p = self.rx(pos, _STR_VALUE_RE, "string value")
        if s is None:
            return None, pos
        return N.StrArg(s), p

    def p_chain_keyword(self, pos: int):
        p = self.lit(pos, "chain")
        if p is None:
            return None, pos
        p1 = self.ws1(p)
        if p1 is None:
            return None, pos
        chars = []
        p = p1
        while p < self.n and self.text[p].isalnum():
            c = self.text[p]
            nxt = p + 1
            if nxt < self.n and _WORD_CHAR.match(self.text[nxt]):
                break  # multi-char token: not a chain id
            chars.append(c)
            p = nxt
            p2 = self.ws1(p)
            if p2 is None:
                break
            if p2 < self.n and self.text[p2].isalnum() and (
                p2 + 1 >= self.n or not _WORD_CHAR.match(self.text[p2 + 1])
            ):
                p = p2
            else:
                break
        if not chars:
            return None, pos
        return N.Keyword(N.KeywordKind.CHAIN, [N.StrArg(c) for c in chars]), p

    def p_keyword_expr(self, pos: int):
        for fn in (self.p_int_keyword, self.p_str_keyword, self.p_chain_keyword):
            v, p = fn(pos)
            if v is not None:
                return v, p
        return None, pos

    # -- pbc ----------------------------------------------------------------

    def p_pbc_expr(self, pos: int):
        """pbc [DDD] / nopbc; consumes the trailing mandatory whitespace."""
        p = self.lit(pos, "pbc")
        if p is not None:
            p1 = self.ws1(p)
            if p1 is not None:
                # try 3 dims
                if p1 + 3 <= self.n and all(c in "01yn" for c in self.text[p1 : p1 + 3]):
                    p2 = self.ws1(p1 + 3)
                    if p2 is not None:
                        d = self.text[p1 : p1 + 3]
                        return PbcDims(*(c in "1y" for c in d)), p2
                return PBC_FULL, p1
        p = self.lit(pos, "nopbc")
        if p is not None:
            p1 = self.ws1(p)
            if p1 is not None:
                return PBC_NONE, p1
        return None, pos

    # -- vectors -------------------------------------------------------------

    def p_vec3(self, pos: int):
        # three floats separated by whitespace
        x, p = self.p_float(pos)
        if x is not None:
            p1 = self.ws1(p)
            if p1 is not None:
                y, p2 = self.p_float(p1)
                if y is not None:
                    p3 = self.ws1(p2)
                    if p3 is not None:
                        z, p4 = self.p_float(p3)
                        if z is not None:
                            return N.VecConst(np.array([x, y, z])), p4
        # bracketed [x, y, z]
        p = self.lit(pos, "[")
        if p is not None:
            p = self.ws(p)
            x, p = self.p_float(p)
            if x is not None:
                p = self.ws(p)
                p2 = self.lit(p, ",")
                if p2 is not None:
                    p2 = self.ws(p2)
                    y, p2 = self.p_float(p2)
                    if y is not None:
                        p2 = self.ws(p2)
                        p3 = self.lit(p2, ",")
                        if p3 is not None:
                            p3 = self.ws(p3)
                            z, p3 = self.p_float(p3)
                            if z is not None:
                                p3 = self.ws(p3)
                                p4 = self.lit(p3, "]")
                                if p4 is not None:
                                    return N.VecConst(np.array([x, y, z])), p4
        # com/cog of
        for kw, cls in (("com", N.VecCom), ("cog", N.VecCog)):
            p = self.lit(pos, kw)
            if p is None:
                continue
            p1 = self.ws1(p)
            if p1 is None:
                continue
            pbc, p2 = self.p_pbc_expr(p1)
            if pbc is None:
                pbc, p2 = PBC_NONE, p1
            p3 = self.lit(p2, "of")
            if p3 is None:
                continue
            p4 = self.ws1_or_paren(p3)
            if p4 is None:
                continue
            inner, p5 = self.p_logical(p4)
            if inner is not None:
                return cls(inner, pbc), p5
        # pos N of
        p = self.lit(pos, "pos")
        if p is not None:
            p1 = self.ws1(p)
            if p1 is not None:
                nth, p2 = self.p_uint(p1)
                if nth is not None:
                    p3 = self.ws1(p2)
                    if p3 is not None:
                        p4 = self.lit(p3, "of")
                        if p4 is not None:
                            p5 = self.ws1_or_paren(p4)
                            if p5 is not None:
                                inner, p6 = self.p_logical(p5)
                                if inner is not None:
                                    return N.VecNthAtom(inner, nth), p6
        return None, pos

    # -- distance -------------------------------------------------------------

    def p_distance(self, pos: int):
        p = self.lit(pos, "dist")
        if p is None:
            return None, pos
        p1 = self.ws1(p)
        if p1 is None:
            return None, pos
        pbc, p2 = self.p_pbc_expr(p1)
        if pbc is None:
            pbc, p2 = PBC_NONE, p1
        # point
        p3 = self.lit(p2, "point")
        if p3 is not None:
            p4 = self.ws1(p3)
            if p4 is not None:
                v, p5 = self.p_vec3(p4)
                if v is not None:
                    return N.DistPoint(v, pbc), p5
        # line: 2 points or point + dir
        p3 = self.lit(p2, "line")
        if p3 is not None:
            p4 = self.ws1(p3)
            if p4 is not None:
                v1, p5 = self.p_vec3(p4)
                if v1 is not None:
                    p6 = self.ws1(p5)
                    if p6 is not None:
                        pd = self.lit(p6, "dir")
                        if pd is not None:
                            p7 = self.ws1(pd)
                            if p7 is not None:
                                d, p8 = self.p_vec3(p7)
                                if d is not None:
                                    return N.DistLineDir(v1, d, pbc), p8
                        v2, p7 = self.p_vec3(p6)
                        if v2 is not None:
                            return N.DistLine(v1, v2, pbc), p7
        # plane: 3 points or point + normal
        p3 = self.lit(p2, "plane")
        if p3 is not None:
            p4 = self.ws1(p3)
            if p4 is not None:
                v1, p5 = self.p_vec3(p4)
                if v1 is not None:
                    p6 = self.ws1(p5)
                    if p6 is not None:
                        pn = self.lit(p6, "normal")
                        if pn is not None:
                            p7 = self.ws1(pn)
                            if p7 is not None:
                                nv, p8 = self.p_vec3(p7)
                                if nv is not None:
                                    return N.DistPlaneNormal(v1, nv, pbc), p8
                        v2, p7 = self.p_vec3(p6)
                        if v2 is not None:
                            p8 = self.ws1(p7)
                            if p8 is not None:
                                v3, p9 = self.p_vec3(p8)
                                if v3 is not None:
                                    return N.DistPlane(v1, v2, v3, pbc), p9
        return None, pos

    # -- math -----------------------------------------------------------------

    def p_math(self, pos: int):
        return self.p_math_add(pos)

    def p_math_add(self, pos: int):
        left, p = self.p_math_mul(pos)
        if left is None:
            return None, pos
        while True:
            p1 = self.ws(p)
            if p1 < self.n and self.text[p1] in "+-":
                op = self.text[p1]
                p2 = self.ws(p1 + 1)
                right, p3 = self.p_math_mul(p2)
                if right is None:
                    break
                left = N.MathBinary(op, left, right)
                p = p3
            else:
                break
        return left, p

    def p_math_mul(self, pos: int):
        left, p = self.p_math_pow(pos)
        if left is None:
            return None, pos
        while True:
            p1 = self.ws(p)
            if p1 < self.n and self.text[p1] in "*/":
                op = self.text[p1]
                p2 = self.ws(p1 + 1)
                right, p3 = self.p_math_pow(p2)
                if right is None:
                    break
                left = N.MathBinary(op, left, right)
                p = p3
            else:
                break
        return left, p

    def p_math_pow(self, pos: int):
        base, p = self.p_math_unary(pos)
        if base is None:
            return None, pos
        p1 = self.ws(p)
        p2 = self.lit(p1, "^")
        if p2 is not None:
            p3 = self.ws(p2)
            exp, p4 = self.p_math_pow(p3)  # right-assoc
            if exp is not None:
                return N.MathBinary("^", base, exp), p4
        return base, p

    def p_math_unary(self, pos: int):
        p = self.lit(pos, "-")
        if p is not None:
            p1 = self.ws(p)
            v, p2 = self.p_math_unary(p1)
            if v is not None:
                return N.MathNeg(v), p2
        p = self.lit(pos, "+")
        if p is not None:
            p1 = self.ws(p)
            v, p2 = self.p_math_unary(p1)
            if v is not None:
                return v, p2
        return self.p_math_atom(pos)

    _AXIS = {"x": 0, "X": 0, "y": 1, "Y": 1, "z": 2, "Z": 2}

    def p_math_atom(self, pos: int):
        v, p = self.p_float(pos)
        if v is not None:
            return N.MathConst(v), p
        # x/y/z of <vec3>  then bare x/y/z
        if pos < self.n and self.text[pos] in "xXyYzZ":
            axis = self._AXIS[self.text[pos]]
            p1 = self.ws1(pos + 1)
            if p1 is not None:
                p2 = self.lit(p1, "of")
                if p2 is not None:
                    p3 = self.ws1_or_paren(p2)
                    if p3 is not None:
                        vec, p4 = self.p_vec3(p3)
                        if vec is not None:
                            return N.MathComponentOf(axis, vec), p4
            return N.MathAttr((N.MathVar.X, N.MathVar.Y, N.MathVar.Z)[axis]), pos + 1
        for kw, var in (
            ("vx", N.MathVar.VX),
            ("vy", N.MathVar.VY),
            ("vz", N.MathVar.VZ),
            ("fx", N.MathVar.FX),
            ("fy", N.MathVar.FY),
            ("fz", N.MathVar.FZ),
            ("vdw", N.MathVar.VDW),
            ("mass", N.MathVar.MASS),
            ("charge", N.MathVar.CHARGE),
            ("occupancy", N.MathVar.OCCUPANCY),
            ("occ", N.MathVar.OCCUPANCY),
            ("bfactor", N.MathVar.BFACTOR),
            ("beta", N.MathVar.BFACTOR),
            ("resindex", N.MathVar.RESINDEX),
            ("resid", N.MathVar.RESID),
            ("index", N.MathVar.INDEX),
        ):
            p = self.lit(pos, kw)
            if p is not None:
                return N.MathAttr(var), p
        d, p = self.p_distance(pos)
        if d is not None:
            return N.MathDist(d), p
        for fname in ("abs", "sqrt", "sin", "cos"):
            p = self.lit(pos, fname)
            if p is None:
                continue
            p1 = self.ws(p)
            p2 = self.lit(p1, "(")
            if p2 is None:
                continue
            p3 = self.ws(p2)
            e, p4 = self.p_math(p3)
            if e is not None:
                p5 = self.ws(p4)
                p6 = self.lit(p5, ")")
                if p6 is not None:
                    return N.MathFunc(fname, e), p6
        p = self.lit(pos, "(")
        if p is not None:
            p1 = self.ws(p)
            e, p2 = self.p_math(p1)
            if e is not None:
                p3 = self.ws(p2)
                p4 = self.lit(p3, ")")
                if p4 is not None:
                    return e, p4
        return None, pos

    # -- comparisons -----------------------------------------------------------

    def p_cmp_op(self, pos: int):
        for op in _CMP_OPS:
            p = self.lit(pos, op)
            if p is not None:
                return op, p
        return None, pos

    def p_comparison(self, pos: int):
        a, p = self.p_math(pos)
        if a is None:
            return None, pos
        p1 = self.ws(p)
        op1, p2 = self.p_cmp_op(p1)
        if op1 is None:
            return None, pos
        p3 = self.ws(p2)
        b, p4 = self.p_math(p3)
        if b is None:
            return None, pos
        # optional chained second comparison (both ops < family or > family)
        p5 = self.ws(p4)
        op2, p6 = self.p_cmp_op(p5)
        if op2 is not None and op1 in ("<", "<=", ">", ">=") and (op2[0] == op1[0]):
            p7 = self.ws(p6)
            c, p8 = self.p_math(p7)
            if c is not None:
                return N.Comparison([a, b, c], [op1, op2]), p8
        return N.Comparison([a, b], [op1]), p4

    # -- compounds --------------------------------------------------------------

    _COMPOUNDS = (
        ("protein", N.Chemical.PROTEIN),
        ("backbone", N.Chemical.BACKBONE),
        ("sidechain", N.Chemical.SIDECHAIN),
        ("water", N.Chemical.WATER),
        ("now", N.Chemical.NOT_WATER),
        ("apolh", N.Chemical.APOLAR_H),
        ("polh", N.Chemical.POLAR_H),
        ("hydrogen", N.Chemical.HYDROGEN),
        ("noh", N.Chemical.NOT_HYDROGEN),
    )

    def p_compound(self, pos: int):
        for kw, chem in self._COMPOUNDS:
            p = self.word(pos, kw)
            if p is not None:
                return N.LChemical(chem), self.ws(p)
        return None, pos

    # -- within ------------------------------------------------------------------

    def p_within_params(self, pos: int):
        p = self.lit(pos, "within")
        if p is None:
            return None, pos
        p1 = self.ws1(p)
        if p1 is None:
            return None, pos
        cutoff, p2 = self.p_float(p1)
        if cutoff is None:
            return None, pos
        p3 = self.ws1(p2)
        if p3 is None:
            return None, pos
        pbc, p4 = self.p_pbc_expr(p3)
        if pbc is None:
            pbc, p4 = PBC_NONE, p3
        include_inner = False
        p5 = self.lit(p4, "self")
        if p5 is not None:
            p6 = self.ws1(p5)
            if p6 is not None:
                include_inner = True
                p4 = p6
        p7 = self.lit(p4, "of")
        if p7 is None:
            return None, pos
        return N.WithinParams(cutoff, pbc, include_inner), p7

    # -- logical -----------------------------------------------------------------

    def p_logical(self, pos: int):
        """or/and level: left-assoc, same precedence (grammar parity)."""
        left, p = self.p_unary(pos)
        if left is None:
            return None, pos
        while True:
            p1 = self.ws(p)
            p_or = self.word(p1, "or")
            if p_or is not None:
                p2 = self.ws(p_or)
                right, p3 = self.p_unary(p2)
                if right is None:
                    break
                left = N.LOr(left, right)
                p = p3
                continue
            p_and = self.word(p1, "and")
            if p_and is not None:
                p2 = self.ws(p_and)
                right, p3 = self.p_unary(p2)
                if right is None:
                    break
                left = N.LAnd(left, right)
                p = p3
                continue
            break
        return left, p

    def p_unary(self, pos: int):
        # not
        p = self.word(pos, "not")
        if p is not None:
            p1 = self.ws1_or_paren(p)
            if p1 is not None:
                v, p2 = self.p_unary(p1)
                if v is not None:
                    return N.LNot(v), p2
        # same ... as
        p = self.lit(pos, "same")
        if p is not None:
            p1 = self.ws1(p)
            if p1 is not None:
                for kw, attr in (("residue", N.SameAttr.RESIDUE), ("chain", N.SameAttr.CHAIN)):
                    p2 = self.lit(p1, kw)
                    if p2 is None:
                        continue
                    p3 = self.ws1(p2)
                    if p3 is None:
                        continue
                    p4 = self.lit(p3, "as")
                    if p4 is None:
                        continue
                    p5 = self.ws1_or_paren(p4)
                    if p5 is None:
                        continue
                    v, p6 = self.p_unary(p5)
                    if v is not None:
                        return N.LSame(attr, v), p6
        # within ... of <logical>
        wp, p = self.p_within_params(pos)
        if wp is not None:
            p1 = self.ws1_or_paren(p)
            if p1 is not None:
                v, p2 = self.p_unary(p1)
                if v is not None:
                    return N.LWithin(wp, v), p2
        return self.p_atom(pos)

    def p_atom(self, pos: int):
        kw, p = self.p_keyword_expr(pos)
        if kw is not None:
            return N.LKeyword(kw), p
        cmp_, p = self.p_comparison(pos)
        if cmp_ is not None:
            return N.LComparison(cmp_), p
        comp, p = self.p_compound(pos)
        if comp is not None:
            return comp, p
        # within ... of <point>
        wp, p = self.p_within_params(pos)
        if wp is not None:
            p1 = self.ws1_or_paren(p)
            if p1 is not None:
                v, p2 = self.p_vec3(p1)
                if v is not None:
                    return N.LWithinPoint(wp, v), p2
        p = self.word(pos, "all")
        if p is not None:
            return N.LAll(), self.ws(p)
        p = self.lit(pos, "(")
        if p is not None:
            p1 = self.ws(p)
            v, p2 = self.p_logical(p1)
            if v is not None:
                p3 = self.ws(p2)
                p4 = self.lit(p3, ")")
                if p4 is not None:
                    return v, p4
        return None, pos


def parse(text: str) -> N.Logical:
    """Parse a selection string into an AST; raises SelectionSyntaxError."""
    stripped = text.strip()
    p = _Parser(stripped)
    node, pos = p.p_logical(0)
    pos = p.ws(pos) if node is not None else pos
    if node is None or pos != p.n:
        offset = max(p.fail_pos, pos if node is not None else 0)
        expected = p.fail_expected if p.fail_expected else ["end of input"]
        if node is not None and pos == p.fail_pos:
            expected = expected + ["end of input"]
        raise SelectionSyntaxError(stripped, offset, expected)
    return node
