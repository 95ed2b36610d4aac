"""Needleman-Wunsch global alignment with affine gaps, over arbitrary tokens.

Parity with the reference aligner (molar/src/seq_align.rs): three-layer DP
(S/I/D) with gap cost ``gap_open + gap_extend * k``, full traceback to
Match/Subst/Ins/Del operations. Used to fit structures by *matching atom
names* (measure.rs:651-704: score +1 match / -1 mismatch, open -10, extend
-1; only Match positions feed the Kabsch fit).

The port's copy of ``molar_tpu.ops.seq_align`` (numpy only).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Sequence, TypeVar

import numpy as np

T = TypeVar("T")

_NEG = -(2**30)


class Op(enum.Enum):
    MATCH = "M"
    SUBST = "X"
    INS = "I"  # gap in y (consume x)
    DEL = "D"  # gap in x (consume y)


@dataclass
class Alignment:
    score: int
    operations: list[Op]


def global_align_affine(
    x: Sequence[T],
    y: Sequence[T],
    gap_open: int,
    gap_extend: int,
    score_fn: Callable[[T, T], int],
) -> Alignment:
    m, n = len(x), len(y)
    S = np.full((m + 1, n + 1), _NEG, dtype=np.int64)
    I = np.full((m + 1, n + 1), _NEG, dtype=np.int64)
    D = np.full((m + 1, n + 1), _NEG, dtype=np.int64)
    # traceback: 0=start 1=diag-match 2=diag-subst 3=fromI 4=fromD for S;
    # 0=fromS 1=fromGap for I/D
    tb_s = np.zeros((m + 1, n + 1), dtype=np.int8)
    tb_i = np.zeros((m + 1, n + 1), dtype=np.int8)
    tb_d = np.zeros((m + 1, n + 1), dtype=np.int8)
    S[0, 0] = 0
    for i in range(1, m + 1):
        I[i, 0] = gap_open + gap_extend * i
        tb_i[i, 0] = 0 if i == 1 else 1
        S[i, 0] = I[i, 0]
        tb_s[i, 0] = 3
    for j in range(1, n + 1):
        D[0, j] = gap_open + gap_extend * j
        tb_d[0, j] = 0 if j == 1 else 1
        S[0, j] = D[0, j]
        tb_s[0, j] = 4

    for i in range(1, m + 1):
        xi = x[i - 1]
        for j in range(1, n + 1):
            # I: gap in y (consume x) — move down.
            open_i = S[i - 1, j] + gap_open + gap_extend
            ext_i = I[i - 1, j] + gap_extend
            if open_i >= ext_i:
                I[i, j] = open_i
                tb_i[i, j] = 0
            else:
                I[i, j] = ext_i
                tb_i[i, j] = 1
            # D: gap in x (consume y) — move right.
            open_d = S[i, j - 1] + gap_open + gap_extend
            ext_d = D[i, j - 1] + gap_extend
            if open_d >= ext_d:
                D[i, j] = open_d
                tb_d[i, j] = 0
            else:
                D[i, j] = ext_d
                tb_d[i, j] = 1
            # S: best of diagonal / I / D.
            sc = score_fn(xi, y[j - 1])
            diag = S[i - 1, j - 1] + sc
            best = diag
            tb = 1 if xi == y[j - 1] else 2
            if I[i, j] > best:
                best = I[i, j]
                tb = 3
            if D[i, j] > best:
                best = D[i, j]
                tb = 4
            S[i, j] = best
            tb_s[i, j] = tb

    # Traceback from (m, n) in layer S.
    ops: list[Op] = []
    i, j = m, n
    layer = "S"
    while i > 0 or j > 0:
        if layer == "S":
            t = tb_s[i, j]
            if t == 1:
                ops.append(Op.MATCH)
                i -= 1
                j -= 1
            elif t == 2:
                ops.append(Op.SUBST)
                i -= 1
                j -= 1
            elif t == 3:
                layer = "I"
            elif t == 4:
                layer = "D"
            else:
                break
        elif layer == "I":
            ops.append(Op.INS)
            t = tb_i[i, j]
            i -= 1
            if t == 0:
                layer = "S"
        else:
            ops.append(Op.DEL)
            t = tb_d[i, j]
            j -= 1
            if t == 0:
                layer = "S"
    ops.reverse()
    return Alignment(score=int(S[m, n]), operations=ops)


def matching_atoms_by_name(names1, names2) -> tuple[np.ndarray, np.ndarray]:
    """Local index pairs of name-matched atoms (measure.rs:651-689)."""
    aln = global_align_affine(
        list(names1), list(names2), -10, -1, lambda a, b: 1 if a == b else -1
    )
    mx, my = [], []
    i = j = 0
    for op in aln.operations:
        if op is Op.MATCH:
            mx.append(i)
            my.append(j)
            i += 1
            j += 1
        elif op is Op.SUBST:
            i += 1
            j += 1
        elif op is Op.INS:
            i += 1
        else:
            j += 1
    return np.asarray(mx, dtype=np.int64), np.asarray(my, dtype=np.int64)
