"""Selection language: parser + evaluator + the ``SelectionExpr`` handle, and
``FrameSelection``, the per-frame evaluator of trajectory tasks.

The port of ``molar_tpu.selection``. The parser, the AST and the host
evaluator are the port's own copies of the JAX package's numpy modules;
:mod:`.compiled` is the torch rewrite of its device tier.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from . import nodes
from .evaluator import EvalContext, SelectionEvalError
from .parser import SelectionSyntaxError, parse

__all__ = [
    "SelectionExpr",
    "FrameSelection",
    "SelectionSyntaxError",
    "SelectionEvalError",
    "parse",
    "nodes",
]

class SelectionExpr:
    """A parsed selection expression, reusable across frames of one system."""

    def __init__(self, text: str):
        self.text = text
        self.ast = parse(text)
        self._cache: dict[int, np.ndarray] = {}
        self._cache_top_id: Optional[int] = None

    @property
    def is_state_dependent(self) -> bool:
        return nodes.is_state_dependent(self.ast)

    def _context(self, topology, state, subset) -> EvalContext:
        ctx = EvalContext(topology, state, subset)
        if self._cache_top_id == id(topology):
            ctx._static_cache = self._cache
        else:
            self._cache = ctx._static_cache = {}
            self._cache_top_id = id(topology)
        return ctx

    def apply(self, topology, state, subset: Optional[np.ndarray] = None) -> np.ndarray:
        """Evaluate on the host -> sorted global index array. ``subset``
        restricts both the search domain and the 'global' context."""
        return self._context(topology, state, subset).evaluate(self.ast)

    def compile_device(self, topology, state, cutoff_params=None, device=None,
                       cap_scale: int = 1, subset: Optional[np.ndarray] = None):
        """Compile to a window mask function ``(coords (B, N, 3), boxes,
        invs) -> (masks (B, N), overflow (B,))`` on ``device``, in the
        context of ``subset`` as :meth:`apply` (see :mod:`.compiled`)."""
        from .compiled import compile_selection

        return compile_selection(self.ast, topology, state, cutoff_params, device, cap_scale,
                                 subset)

    def __repr__(self) -> str:
        return f"SelectionExpr({self.text!r})"


class FrameSelection:
    """Per-frame selection evaluator for trajectory tasks, in three tiers:

    1. ``static``: a state-independent expression, evaluated once;
    2. ``device``: a state-dependent expression the compiler accepts, a
       window function on the card (:attr:`compiled`, tier-0 caps) that a
       task's window function calls on device tensors;
    3. ``host``: everything else (dynamic ``same``, ``com of`` vectors,
       velocities/forces — :class:`.compiled.CompileUnsupported`), evaluated
       per frame on the host.

    ``device`` (the device tier's) resolves through
    :func:`~molar_tpu_torch.config.resolve_device`: the card unless the
    caller names another or made the CPU the default (the tests do); without
    a card a state-dependent expression raises, it never falls back to the
    CPU. ``subset`` (sorted global indices) evaluates every tier in a parent
    selection's context, as :meth:`SelectionExpr.apply` does.
    """

    def __init__(self, expr, topology, state0, cutoff_params=None, device=None, subset=None):
        if isinstance(expr, str):
            expr = SelectionExpr(expr)
        self.expr = expr
        self.topology = topology
        self.state0 = state0
        self.cutoff_params = cutoff_params
        self.subset = subset
        self.static_idx: Optional[np.ndarray] = None
        self.compiled = None
        self.device = None
        self._tiers: dict = {}
        if not expr.is_state_dependent:
            self.static_idx = expr.apply(topology, state0, subset)
            return
        from .compiled import CompileUnsupported

        self.device = resolve_device(device)
        try:
            self.compiled = expr.compile_device(topology, state0, cutoff_params, self.device,
                                                subset=subset)
        except CompileUnsupported:
            self.compiled = None  # host tier
        else:
            self._tiers[0] = self.compiled

    @property
    def tier(self) -> str:
        if self.static_idx is not None:
            return "static"
        return "device" if self.compiled is not None else "host"

    def _compiled_at(self, tier: int):
        from .compiled import CAP_TIERS

        fn = self._tiers.get(tier)
        if fn is None:
            fn = self._tiers[tier] = self.expr.compile_device(
                self.topology, self.state0, self.cutoff_params, self.device,
                cap_scale=CAP_TIERS[tier], subset=self.subset)
        return fn

    def eval_frame(self, state) -> np.ndarray:
        """Sorted global indices selected in ``state`` (host-side answer)."""
        if self.static_idx is not None:
            return self.static_idx
        if self.compiled is not None:
            box = state.box
            boxes = None if box is None else box.matrix[None]
            invs = None if box is None else box.inv[None]
            return np.flatnonzero(self.eval_window(state.coords[None], boxes, invs)[0])
        return self.expr.apply(self.topology, state, self.subset)

    def eval_window(self, coords, boxes, invs) -> np.ndarray:
        """(B, n_atoms) boolean masks for a window of frames (numpy arrays or
        tensors).

        Device tier: the compiled window function, masks and overflow flags
        read back in one copy; a window whose flags are set is run again at
        the next capacity tier (:func:`.compiled.over_tiers`), after which
        :class:`~molar_tpu_torch.tasks.trajectory.AnalysisError` is raised. Host tier: per-frame re-evaluation. Static tier: the
        constant mask broadcast.
        """
        n = self.topology.n_atoms
        if self.static_idx is not None:
            m = np.zeros(n, dtype=bool)
            m[self.static_idx] = True
            return np.broadcast_to(m, (len(coords), n)).copy()
        if self.compiled is not None:
            from ..tasks.trajectory import AnalysisError
            from .compiled import over_tiers

            def dev(a):
                return None if a is None else torch.as_tensor(a, dtype=torch.float32).to(
                    self.device)

            c, b, i = dev(coords), dev(boxes), dev(invs)

            def attempt(tier, _scale):
                masks, overflow = self._compiled_at(tier)(c, b, i)
                out = torch.cat([masks, overflow[:, None]], dim=1).cpu().numpy()
                return None if out[:, n].any() else out[:, :n]

            return over_tiers(attempt, f"selection {self.expr.text!r}", AnalysisError)
        from ..core.pbc import PeriodicBox
        from ..core.state import State

        coords, boxes = _host(coords), _host(boxes)
        out = np.zeros((coords.shape[0], n), dtype=bool)
        for k in range(coords.shape[0]):
            box = None if boxes is None else PeriodicBox(boxes[k])
            out[k, self.expr.apply(self.topology, State(coords=coords[k], box=box),
                                   self.subset)] = True
        return out


def _host(a):
    """A tensor's or an array's values as a numpy array (None stays None)."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return None if a is None else np.asarray(a)
