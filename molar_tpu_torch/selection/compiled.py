"""Device-compiled selections: state-dependent expressions as torch window
mask functions.

The port of ``molar_tpu.selection.compiled``. Topology-only subtrees
collapse to constant masks built once on the device (the ``Precomputed``
analog), and coordinate-dependent nodes compile to a function of a whole
window, ``(coords (B, N, 3), boxes (B, 3, 3), invs (B, 3, 3)) -> (masks (B,
N) bool, overflow (B,) bool)``, on the coords' device, that never reads a
value back to the host.

Supported dynamic nodes, as in the JAX package: coordinate math
comparisons (x/y/z with the full math grammar over static attributes,
chained comparisons), ``within CUTOFF [pbc] [self] of <static inner>``,
``within ... of <const point>``, and any and/or/not combination with static
subtrees. The rest (a dynamic ``within`` inner, a dynamic point,
velocities and forces, ``same`` / ``dist`` / ``com`` of dynamic selections)
raise :class:`CompileUnsupported`: the host tier evaluates those.

``within`` nodes take :func:`~molar_tpu_torch.ops.neighbor.within_mask_window`
over the whole window (on CUDA tensors one ``cell_bins`` and one
``within_ghost`` launch a node a window) when the box is orthorhombic, and
the per-frame correction route of a skewed box otherwise (its 26 candidates
from each frame's own box, the grid from the cell heights). Where the JAX
package departs from its host evaluator the port does not follow it:

* the overflow flag of every search is returned (the JAX function drops it
  and can return a wrong set); a caller retries at larger caps;
* a skewed box's grid is sized by :func:`~molar_tpu_torch.ops.neighbor.grid_dims_for`
  (the JAX function's length-sized grid misses atoms);
* a non-periodic axis of a ``within`` (``nopbc``, or ``pbc`` with some axes
  off, in an orthorhombic box) is binned in a window box of the frame's
  own, the frame's coordinate span on that axis (never less than the
  representative frame's) from the frame's minimum, built on the device:
  no atom is wrapped across it, and no cell is thinner than the cutoff (the
  JAX function bins in the periodic box and so wraps atoms outside it);
* partial PBC in a skewed box is left to the host tier
  (:class:`CompileUnsupported`): its non-periodic axes are not separable
  from the lattice.

Error semantics as in the JAX package: on the device a division by zero and
the square root of a negative yield inf / NaN (comparisons with NaN are
False) instead of the host evaluator's errors. Math constants are 0-d
device tensors, so ``x / 2`` is a true division on every device (a Python
float divisor is a product by its reciprocal on CUDA).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..core.periodic_table import ELEMENT_VDW_NM, NUM_ELEMENTS
from ..ops import neighbor
from . import nodes as N
from .evaluator import EvalContext

# The 26 lattice combinations (i, j, k) != 0, unpruned: a frame's correction
# candidates are these times its own box columns (zero-cost rows for the
# ones a pruned table would drop), so a box that changes stays exact.
_IJK = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
                 if (i, j, k) != (0, 0, 0)], dtype=np.float32)

#: Margin (nm) of a non-periodic window box beyond the coordinate span, so
#: that every fractional coordinate stays below 1.
SPAN_PAD = 1e-3

#: Capacity scales of a search's overflow retry (:func:`over_tiers`): a
#: search whose flag is set runs again at the next (three tiers, as the
#: headline's ``run_with_overflow_retry`` default).
CAP_TIERS = (1, 2, 4)


class CompileUnsupported(NotImplementedError):
    pass


class CompiledSelection:
    """The compiled window function and its static metadata: ``n_atoms``,
    ``uses_box``, ``device`` and ``ghost_nodes`` (the ``within`` searches
    on the ghost route: on CUDA one ``cell_bins`` and one ``within_ghost``
    launch each a window)."""

    def __init__(self, fn: Callable, n_atoms: int, uses_box: bool, ghost_nodes: int, device):
        self._fn = fn
        self.n_atoms = n_atoms
        self.uses_box = uses_box
        self.ghost_nodes = ghost_nodes
        self.device = device
        self._eye = torch.eye(3, dtype=torch.float32, device=device)

    @torch.no_grad()
    def __call__(self, coords, boxes=None, invs=None):
        """``coords`` (B, N, 3) f32 on :attr:`device` -> (masks (B, N) bool,
        overflow (B,) bool). ``boxes``/``invs`` (B, 3, 3) are required when
        the expression searches under PBC; a mask is undefined where its
        frame's flag is set."""
        b = coords.shape[0]
        if boxes is None:
            if self.uses_box:
                raise ValueError("this selection needs the frames' boxes")
            boxes = invs = self._eye.expand(b, 3, 3)
        mask, ofl = self._fn(coords, boxes, invs)
        mask = mask.expand(b, self.n_atoms)
        if mask.stride(0) == 0:
            mask = mask.contiguous()
        if ofl is None:
            ofl = torch.zeros(b, dtype=torch.bool, device=coords.device)
        return mask, ofl


def _or(a, b):
    if a is None:
        return b
    return a if b is None else a | b


def compile_selection(
    ast: N.Logical,
    topology,
    state,
    cutoff_params: Optional[dict] = None,
    device=None,
    cap_scale: int = 1,
    subset: Optional[np.ndarray] = None,
) -> CompiledSelection:
    """Compile an AST against a topology and a representative state (which
    sizes the cell grids and caps of ``within`` nodes) for ``device``
    (None: :func:`~molar_tpu_torch.config.resolve_device`).

    ``cutoff_params``: optional overrides {"cap": int, "tgt_cap": int,
    "max_tgt_cells": int} of the searches. ``cap_scale`` multiplies every
    cap (the overflow retry's tiers). ``subset`` (sorted global indices)
    evaluates in a parent selection's context, as the host evaluator's
    ``global_subset``: the static masks and the ``within`` targets are taken
    inside it, and the result is cut to it.
    """
    device = resolve_device(device)
    n = topology.n_atoms
    host_ctx = EvalContext(topology, state, subset)
    params = {"cap": None, "tgt_cap": None, "max_tgt_cells": None}
    params.update(cutoff_params or {})
    uses_box = [False]
    n_ghost = [0]

    def const(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    def static_mask(node) -> np.ndarray:
        return host_ctx.eval_mask(node, host_ctx.global_mask)

    def build(node) -> Callable:
        if not N.is_state_dependent(node):
            m = const(static_mask(node), torch.bool)
            return lambda c, b, i: (m, None)
        if isinstance(node, N.LAnd):
            fa, fb = build(node.left), build(node.right)

            def f_and(c, b, i):
                (ma, oa), (mb, ob) = fa(c, b, i), fb(c, b, i)
                return ma & mb, _or(oa, ob)
            return f_and
        if isinstance(node, N.LOr):
            fa, fb = build(node.left), build(node.right)

            def f_or(c, b, i):
                (ma, oa), (mb, ob) = fa(c, b, i), fb(c, b, i)
                return ma | mb, _or(oa, ob)
            return f_or
        if isinstance(node, N.LNot):
            fo = build(node.operand)

            def f_not(c, b, i):
                m, o = fo(c, b, i)
                return ~m, o
            return f_not
        if isinstance(node, N.LComparison):
            return build_comparison(node.comparison)
        if isinstance(node, N.LWithin):
            if N.is_state_dependent(node.inner):
                raise CompileUnsupported("within over a state-dependent inner selection")
            inner = static_mask(node.inner)
            return build_within(node.params, np.flatnonzero(inner), inner)
        if isinstance(node, N.LWithinPoint):
            if not isinstance(node.point, N.VecConst):
                raise CompileUnsupported("within of a dynamic point")
            pt = np.asarray(node.point.value, np.float32).reshape(1, 3)
            return build_within(node.params, pt, None, is_point=True)
        raise CompileUnsupported(type(node).__name__)

    def build_math(e) -> Callable:
        if isinstance(e, N.MathConst):
            v = const(np.float32(e.value), torch.float32)
            return lambda c: v
        if isinstance(e, N.MathAttr):
            V = N.MathVar
            if e.var in (V.X, V.Y, V.Z):
                ax = (V.X, V.Y, V.Z).index(e.var)
                return lambda c: c[..., ax]
            if e.var in (V.VX, V.VY, V.VZ, V.FX, V.FY, V.FZ):
                raise CompileUnsupported("velocities/forces on device")
            col = {
                V.MASS: topology.mass,
                V.CHARGE: topology.charge,
                V.OCCUPANCY: topology.occupancy,
                V.BFACTOR: topology.bfactor,
                V.RESID: topology.resid,
                V.RESINDEX: topology.resindex,
                V.INDEX: np.arange(n),
            }.get(e.var)
            if col is None and e.var is V.VDW:
                col = ELEMENT_VDW_NM[np.clip(topology.atomic_number, 0, NUM_ELEMENTS - 1)]
            v = const(np.asarray(col, np.float32), torch.float32)
            return lambda c: v
        if isinstance(e, N.MathBinary):
            fa, fb = build_math(e.left), build_math(e.right)
            op = {"+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
                  "^": torch.pow}[e.op]
            return lambda c: op(fa(c), fb(c))
        if isinstance(e, N.MathNeg):
            f = build_math(e.operand)
            return lambda c: -f(c)
        if isinstance(e, N.MathFunc):
            f = build_math(e.operand)
            g = {"abs": torch.abs, "sqrt": torch.sqrt, "sin": torch.sin, "cos": torch.cos}[e.name]
            return lambda c: g(f(c))
        raise CompileUnsupported(type(e).__name__)

    def build_comparison(cmp_) -> Callable:
        fns = [build_math(t) for t in cmp_.terms]
        ops = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge, "==": torch.eq,
               "!=": torch.ne}
        o1 = ops[cmp_.ops[0]]
        if len(cmp_.ops) == 1:
            return lambda c, b, i: (o1(fns[0](c), fns[1](c)), None)
        o2 = ops[cmp_.ops[1]]

        def f(c, b, i):
            mid = fns[1](c)
            return o1(fns[0](c), mid) & o2(mid, fns[2](c)), None

        return f

    def build_within(p: N.WithinParams, target, inner_mask, is_point=False):
        pbc = p.pbc.as_tuple()
        tric = p.pbc.any and state.box is not None and state.box.is_triclinic
        if p.pbc.any and state.box is None:
            raise CompileUnsupported("pbc within without a box")
        if tric and not p.pbc.all:
            raise CompileUnsupported("partial PBC in a skewed box")
        if not is_point and not len(target):
            nothing = const(np.zeros(n, bool), torch.bool)
            return lambda c, b, i: (nothing, None)
        n_ghost[0] += not tric
        coords0 = np.concatenate([state.coords, target]) if is_point else state.coords
        dims, span_np = search_grid(coords0, p.cutoff, state.box, pbc)
        uses_box[0] |= p.pbc.any
        span0 = None if p.pbc.all else const(span_np, torch.float32)
        sets = [np.arange(n)] + ([] if is_point else [np.asarray(target)])
        caps = search_caps(coords0, dims, pbc, state.box, *sets)
        cap = (params["cap"] or caps[0]) * cap_scale
        tcap = 8 * cap_scale if is_point else (params["tgt_cap"] or caps[1]) * cap_scale
        mtc = params["max_tgt_cells"]
        include = p.include_inner and inner_mask is not None
        inner_t = const(inner_mask, torch.bool) if include else None
        ijk = const(_IJK, torch.float32) if tric else None
        if is_point:
            point = const(target, torch.float32)
            src = torch.arange(n, device=device)
            tgt = torch.tensor([n], device=device)
        else:
            src = None
            tgt = const(np.asarray(target, np.int64), torch.int64)

        def f(c, b, i):
            if is_point:
                c = torch.cat([c, point.expand(c.shape[0], 1, 3)], dim=1)
            if span0 is not None:
                c, b, i = window_box(c, b, i, span0, pbc)
            if tric:
                mask, ofl = within_corrections(c, src, tgt, p.cutoff, b, i, ijk, dims, cap,
                                                tcap, pbc, mtc)
            else:
                mask, ofl = neighbor.within_mask_window(c, src, tgt, p.cutoff, b, i, dims,
                                                        cap=cap, tgt_cap=tcap, pbc=pbc)
            if include:
                mask = mask | inner_t
            return mask, ofl

        return f

    fn = build(ast)
    if subset is not None:
        # Every node is pointwise over the atoms, so the host evaluator's
        # restriction to the current subset at each node is this one cut.
        domain = const(host_ctx.global_mask, torch.bool)
        inner_fn = fn

        def fn(c, b, i):
            m, o = inner_fn(c, b, i)
            return m & domain, o
    return CompiledSelection(fn, n, uses_box[0], n_ghost[0], device)


def search_grid(coords0, cutoff: float, box, pbc) -> tuple[tuple[int, int, int], np.ndarray]:
    """The cell grid a ``within`` search over the rows ``coords0`` bins in,
    and their span (3,) float32: on a periodic axis the box's
    (:func:`~molar_tpu_torch.ops.neighbor.grid_dims_for`), on a non-periodic
    one the span's plus :data:`SPAN_PAD`, binned in :func:`window_box`."""
    span = coords0.max(axis=0) - coords0.min(axis=0)
    dims = neighbor.grid_dims(span + SPAN_PAD, cutoff)
    if any(pbc):
        dims = tuple(d if per else s for d, s, per in
                     zip(neighbor.grid_dims_for(box, cutoff), dims, pbc))
    return dims, span.astype(np.float32)


def search_caps(coords0, dims, pbc, box, *index_sets) -> tuple[int, ...]:
    """For each index array of ``index_sets``: the max per-cell occupancy
    of those rows of ``coords0`` on :func:`search_grid`'s grid (the
    periodic axes wrapped in ``box``, the others in the span of every row),
    + 50% headroom: a clobbered fixed-capacity table corrupts results in
    BOTH directions, so caps are sized from the data. One pass over the
    rows for every set."""
    frac = None
    if not all(pbc):
        lo = coords0.min(axis=0)
        frac = (coords0 - lo) / (coords0.max(axis=0) - lo + SPAN_PAD)
    if any(pbc):
        wrapped = coords0 @ box.inv.T
        wrapped = wrapped - np.floor(wrapped)
        frac = wrapped if frac is None else np.where(pbc, wrapped, frac)
    cell = np.minimum((frac * dims).astype(np.int64), np.asarray(dims) - 1)
    flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    caps = []
    for idx in index_sets:
        peak = int(np.bincount(flat[idx]).max()) if len(idx) else 1
        caps.append(max(int(peak * 1.5) + 4, 8))
    return tuple(caps)


def over_tiers(attempt: Callable, what: str, error=RuntimeError):
    """``attempt(tier, scale)`` at each of :data:`CAP_TIERS` until it
    returns a result (None: its search's overflow flag was set, and nothing
    of it may be read) -> that result; ``error`` once the last tier
    overflows too."""
    for tier, scale in enumerate(CAP_TIERS):
        out = attempt(tier, scale)
        if out is not None:
            return out
    raise error(f"{what} still overflows at the largest capacity tier {len(CAP_TIERS) - 1} "
                f"(caps x{CAP_TIERS[-1]})")


def window_box(c, boxes, invs, span0, pbc):
    """The frame boxes of a search with non-periodic axes (an orthorhombic
    box, or none): on each non-periodic axis the side ``max(span_f, span_0)
    + pad`` and the coordinates moved by the frame's minimum, so that no
    atom wraps and no cell is thinner than the cutoff; the periodic axes
    keep the frame's box. All on the device -> (coords, boxes, invs)."""
    lo = c.amin(dim=1)
    side = torch.maximum(c.amax(dim=1) - lo, span0) + SPAN_PAD
    if not any(pbc):
        return c - lo[:, None, :], torch.diag_embed(side), torch.diag_embed(torch.reciprocal(side))
    boxes, invs = boxes.clone(), invs.clone()
    shift = torch.zeros_like(lo)
    for a in range(3):
        if not pbc[a]:
            boxes[:, a, a] = side[:, a]
            invs[:, a, a] = torch.reciprocal(side[:, a])
            shift[:, a] = lo[:, a]
    return c - shift[:, None, :], boxes, invs


def within_corrections(c, src, tgt, cutoff, boxes, invs, ijk, dims, cap, tgt_cap, pbc,
                       max_tgt_cells):
    """The correction route of a skewed box, frame by frame: the 26
    candidates ``i*a + j*b + k*c`` of each frame's box, elementwise."""
    corr = (ijk[None, :, 0:1] * boxes[:, None, :, 0] + ijk[None, :, 1:2] * boxes[:, None, :, 1]
            + ijk[None, :, 2:3] * boxes[:, None, :, 2])
    masks, flags = [], []
    for f in range(c.shape[0]):
        m, o = neighbor.within_mask(c[f], src, tgt, cutoff, boxes[f], invs[f], corrections=corr[f],
                                    dims=dims, cap=cap, pbc=pbc, tgt_cap=tgt_cap,
                                    max_tgt_cells=max_tgt_cells)
        masks.append(m)
        flags.append(o)
    return torch.stack(masks), torch.stack(flags)
