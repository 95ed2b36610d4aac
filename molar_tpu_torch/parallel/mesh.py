"""Frames sharded over several devices: the port of ``molar_tpu.parallel.mesh``.

Trajectory analysis is embarrassingly parallel over frames, so a window
``(B, N, 3)`` splits into contiguous frame shards, one a device; the
topology's index arrays and the model's buffers are replicated, and the
only cross-device step is gathering the per-frame outputs (or combining a
window mean) on the first device.

A mesh here is a plain list of ``torch.device``s driven by ONE process, as
the JAX package's single controller drives ``jax.devices()``: every caller
(``WindowPipeline(mesh=)``, ``run_with_overflow_retry(mesh=)``,
``WindowAnalysisTask --mesh``, ``workloads.run(mesh=)``) passes a runner
inside one process. Each shard is enqueued under its device
(``torch.cuda.device``), so on several cards the shards run at once; the
CUDA kernel wrappers take the device and stream of their tensors. A device
may appear more than once (several shards on one card, or on the CPU, which
is how the tests and a one-card machine drive this code).

* :func:`sharded_window_fn`: the body sees one frame shard at a time; its
  per-frame outputs are gathered, and listed window-level outputs must be
  frame means, combined with the shards' frame counts as weights.
* :class:`MeshWindowRunner`: the production path. Pads a ragged window to a
  multiple of the device count by repeating its last frame, splits the
  frame axis, copies each shard (and, once a device, a replica of the
  window module) to its device, runs the shards, gathers the per-frame
  outputs on the first device in frame order and trims the padding.
* :func:`com_gyration_sharded`: the (frames x atoms) split of
  :func:`frame_atom_mesh`; partial mass and moment sums are added on the
  first device where the JAX package takes a ``psum``.
"""

from __future__ import annotations

import copy
from contextlib import nullcontext
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import default_device
from ..convert import transport_to_torch

def _pool(devices) -> list:
    """The devices a mesh is taken from: ``devices``, or every CUDA device
    (raises without one: no CPU fallback), or the one device a caller made
    the default (:func:`~molar_tpu_torch.config.set_default_device`)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    dev = default_device()
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def frame_mesh(n_devices: Optional[int] = None, devices=None) -> list:
    """The first ``n_devices`` devices of ``devices`` (default: every CUDA
    device; all of them when ``n_devices`` is None or 0). Like the JAX
    package's ``devs[:n]``, asking for more devices than there are gives
    all there are."""
    devs = _pool(devices)
    return devs[: n_devices or len(devs)]


def frame_atom_mesh(n_frame_devices: int, n_atom_devices: int, devices=None) -> list:
    """A (frames x atoms) grid, ``n_frame_devices`` rows of
    ``n_atom_devices`` devices each, from the first devices of ``devices``
    (default: every CUDA device); raises when there are too few."""
    devs = _pool(devices)
    n = n_frame_devices * n_atom_devices
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return [devs[r * n_atom_devices:(r + 1) * n_atom_devices] for r in range(n_frame_devices)]


def frame_sharding(mesh: Sequence, n_frames: int) -> list:
    """The frame slice each device of ``mesh`` holds of an ``n_frames``
    axis: contiguous, in device order, ``n_frames / len(mesh)`` each."""
    n = len(mesh)
    if n_frames % n:
        raise ValueError(f"{n_frames} frames do not split over {n} devices: pad them first "
                         "(pad_to_multiple)")
    per = n_frames // n
    return [slice(k * per, (k + 1) * per) for k in range(n)]


def replicated_sharding(mesh: Sequence, a) -> list:
    """``a`` (an array or a tensor) copied whole to every device of
    ``mesh``, one tensor a device."""
    t = torch.as_tensor(a)
    return [t.to(d) for d in mesh]


def shard_window(mesh: Sequence, *arrays):
    """Window arrays with the leading (frame) axis split over ``mesh`` ->
    for each array the list of its shards, one a device. The frame count
    must split evenly; :class:`MeshWindowRunner` pads ragged windows
    (:func:`pad_to_multiple`) first."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        out.append([t[s].to(d) for s, d in zip(frame_sharding(mesh, t.shape[0]), mesh)])
    return tuple(out)


def pad_to_multiple(arrays, multiple: int):
    """Pad every array's leading (frame) axis to a multiple of ``multiple``
    -> (padded arrays, valid mask). Padding repeats the last frame, and the
    mask excludes it from reductions."""
    b = arrays[0].shape[0]
    rem = (-b) % multiple
    valid = np.ones(b + rem, dtype=bool)
    if rem == 0:
        return arrays, valid
    valid[b:] = False
    out = []
    for a in arrays:
        pad = np.repeat(a[-1:], rem, axis=0)
        out.append(np.concatenate([a, pad], axis=0))
    return tuple(out), valid


def _on(device):
    """The context that makes ``device`` the current CUDA device."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _map(fn, tree):
    """``fn`` over the tensor leaves of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _gather(outs: list, device):
    """Per-shard output trees -> one tree whose leaves are the shards'
    leaves concatenated along the frame axis on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs], dim=0)
    if isinstance(first, dict):
        return {k: _gather([o[k] for o in outs], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([o[i] for o in outs], device) for i in range(len(first)))
    raise TypeError(f"a window function's outputs must be tensors, got {type(first).__name__}")


class _Replicas:
    """One copy of a window function a device: an ``nn.Module`` whose
    tensors lie elsewhere is deep-copied there (its buffers and parameters
    moved), once; a module already there, or any other callable, serves as
    it is (a closure's captured tensors must then sit where it runs)."""

    def __init__(self):
        self._cache: dict = {}

    def __call__(self, fn: Callable, device: torch.device) -> Callable:
        if not isinstance(fn, nn.Module):
            return fn
        key = (id(fn), str(device))
        hit = self._cache.get(key)
        if hit is None:
            tensors = [*fn.parameters(), *fn.buffers()]
            here = all(t.device == device for t in tensors)
            # (the module is kept with its replica, so that its id is not reused)
            hit = self._cache[key] = (fn, fn if here else copy.deepcopy(fn).to(device))
        return hit[1]


def sharded_window_fn(
    window_fn: Callable,
    mesh: Sequence,
    n_frame_args: int = 4,
    replicated_outs: tuple = (),
    n_outs: Optional[int] = None,
) -> Callable:
    """``window_fn`` over frame shards of ``mesh``: the returned function
    takes its first ``n_frame_args`` arguments either as the shard lists of
    :func:`shard_window` or whole (split here; the frame count must split
    evenly), and any further argument replicated; it runs ``window_fn``
    once a shard on the shard's device and gathers each output on the first
    device, in frame order.

    Unlike under the JAX package's SPMD partitioner, the body sees only its
    shard, so a window-level reduction is not global by itself. Outputs
    listed (by index) in ``replicated_outs`` are taken to be MEANS over the
    frames of the shard (``x.mean(0)`` of a per-frame quantity, any shape);
    the shards' means are combined with their frame counts as weights, which
    is the window mean up to float rounding. No other window-level reduction
    (a sum, a maximum, a median, a mean over something else than frames)
    can be combined this way: pass ``replicated_outs`` as a dict index ->
    reduction to say which each is, and every reduction but ``"mean"`` is
    refused. ``replicated_outs`` requires ``n_outs``, the length of the
    output tuple, as in the JAX package."""
    if isinstance(replicated_outs, dict):
        bad = {i: r for i, r in replicated_outs.items() if r != "mean"}
        if bad:
            raise NotImplementedError(
                f"window-level reductions {bad} cannot be combined across frame shards: only "
                "frame means (combined with the shards' frame counts) are supported")
        replicated_outs = tuple(replicated_outs)
    if replicated_outs and n_outs is None:
        raise ValueError("replicated_outs requires n_outs (output tuple length)")
    mesh = [torch.device(d) for d in mesh]
    replicas = _Replicas()

    def fn(*args):
        shards = []
        for k, a in enumerate(args):
            if k >= n_frame_args:
                shards.append(replicated_sharding(mesh, a))
            elif isinstance(a, (list, tuple)):
                shards.append(list(a))
            else:
                shards.append(shard_window(mesh, a)[0])
        outs, counts = [], []
        for s, d in enumerate(mesh):
            with _on(d):
                outs.append(replicas(window_fn, d)(*(col[s] for col in shards)))
            counts.append(shards[0][s].shape[0])
        if not replicated_outs:
            return _gather(outs, mesh[0])
        total = float(sum(counts))
        result = []
        for i in range(n_outs):
            col = [o[i] for o in outs]
            if i in replicated_outs:
                result.append(sum(c.to(mesh[0]) * (n / total) for c, n in zip(col, counts)))
            else:
                result.append(_gather(col, mesh[0]))
        return tuple(result)

    return fn


class MeshWindowRunner:
    """Production frame-sharded execution of a per-window program.

    ``mesh`` is a list of devices (:func:`frame_mesh`). A window function
    ``fn(transport, boxes, invs) -> per-frame results`` (tensors, or tuples,
    lists and dicts of them, each with the frame axis leading) runs once a
    shard on the shard's device; the runner handles what the function
    cannot:

    * **wire forms**: a plain f32 window shards directly; an ``(i16,
      scale)`` pair shards the ints and copies the scale to every device;
      an ``(frame0 i16, deltas i8, scale)`` triple is rebuilt into the i16
      pair on the host first (the prefix sum over frames does not split
      across devices, and the host sum of small ints is exact and cheap);
    * **ragged tails**: a window is padded to a multiple of the device count
      by repeating its last frame (the same results, so no new overflow)
      and the outputs are trimmed back;
    * **replicas**: a window module is copied to each device once
      (:meth:`wrap`'s cache), buffers and all.

    The outputs are gathered on the first device of the mesh.
    """

    def __init__(self, mesh: Sequence):
        self.devices = [torch.device(d) for d in mesh]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.n = len(self.devices)
        self.device = self.devices[0]
        self._replicas = _Replicas()
        self._wrapped: dict = {}

    # -- host-side window preparation ------------------------------------

    @staticmethod
    def _delta_to_i16(coords):
        """(frame0 i16, deltas i8, scale) -> (ints (B, N, 3) i16, scale).
        Exact: the deltas were built from the i16 ints, so every prefix sum
        is again a representable i16 int."""
        f0, d8, scale = coords
        f0 = np.asarray(f0)[None].astype(np.int32)
        ints = np.concatenate([f0, f0 + np.cumsum(np.asarray(d8).astype(np.int32), axis=0)])
        return ints.astype(np.int16), scale

    def prepare(self, coords, boxes, invs):
        """Pad and split one window (host arrays in a wire form of
        ``TrajectoryReader.iter_windows``) over the mesh -> (one ``(transport,
        boxes, invs)`` tuple of tensors a device, the window's frame count,
        the wire form's name). The frames' times are not shipped: no window
        function of the port reads them."""
        if isinstance(coords, tuple) and len(coords) == 3:
            coords = self._delta_to_i16(coords)
        if isinstance(coords, tuple):
            lead, scale = coords
            form = "i16"
        else:
            lead, scale = coords, None
            form = "f32"
        b = lead.shape[0]
        (lead, boxes, invs), _ = pad_to_multiple((np.asarray(lead), np.asarray(boxes),
                                                  np.asarray(invs)), self.n)
        shards = []
        for s, d in zip(frame_sharding(self.devices, lead.shape[0]), self.devices):
            part = lead[s] if scale is None else (lead[s], scale)
            shards.append(transport_to_torch((part, boxes[s], invs[s]), d))
        return shards, b, form

    # -- wrapped function cache ------------------------------------------

    def wrap(self, window_fn: Callable, form: str) -> Callable:
        """``window_fn`` over prepared shards -> a function of the shard
        list that runs each shard on its device (through the device's
        replica of ``window_fn``) and returns the outputs gathered on the
        first device, padding included. One wrapper a (function, form)."""
        key = (id(window_fn), form)
        f = self._wrapped.get(key)
        if f is None:
            def f(shards):
                outs = []
                for args, d in zip(shards, self.devices):
                    with _on(d):
                        outs.append(self._replicas(window_fn, d)(*args))
                return _gather(outs, self.device)

            self._wrapped[key] = f
        return f

    # -- one-shot convenience --------------------------------------------

    def call(self, window_fn: Callable, coords, boxes, invs):
        """Prepare, run and trim one window (host-array inputs)."""
        shards, b, form = self.prepare(coords, boxes, invs)
        return self.trim(self.wrap(window_fn, form)(shards), b)

    @staticmethod
    def trim(result, n_valid: int):
        """Cut the padded frames off every per-frame output leaf."""
        return _map(lambda a: a[:n_valid], result)


def as_runner(mesh) -> Optional[MeshWindowRunner]:
    """``mesh`` (None, a list of devices or a runner) as a runner: a runner
    passes through, so that its replicas are built once."""
    if mesh is None or isinstance(mesh, MeshWindowRunner):
        return mesh
    return MeshWindowRunner(mesh)


def com_gyration_sharded(mesh: Sequence[Sequence]) -> Callable:
    """Per-frame centre of mass and radius of gyration over a (frames x
    atoms)-sharded window (non-periodic; ``measure.rs:120-168``) on a
    :func:`frame_atom_mesh` grid: the frames split over its rows, the atoms
    over its columns, contiguous. Each device reduces its block; the
    partial mass and moment sums are added on the first device (where the
    JAX package takes a ``psum`` over the atom axis), the centres sent back
    for the second moments, and their partial sums added there too.

    Returns ``fn(coords (B, N, 3), masses (N,)) -> (com (B, 3), gyration
    (B,))`` on the first device of the grid."""
    grid = [[torch.device(d) for d in row] for row in mesh]
    first = grid[0][0]

    def fn(coords, masses):
        coords, masses = torch.as_tensor(coords), torch.as_tensor(masses)
        n_cols = len(grid[0])
        m_parts = torch.tensor_split(masses, n_cols)
        blocks = []  # [row][col] -> (device, coords block, masses block)
        for row, frames in zip(grid, torch.tensor_split(coords, len(grid), dim=0)):
            blocks.append([(d, c.to(d), m.to(d)) for d, c, m in
                           zip(row, torch.tensor_split(frames, n_cols, dim=1), m_parts)])
        msum = sum(m.sum().to(first) for _, _, m in blocks[0])
        coms, gyrs = [], []
        for row in blocks:
            wsum = sum((c * m[None, :, None]).sum(dim=1).to(first) for _, c, m in row)
            com = wsum / msum
            g2 = 0.0
            for d, c, m in row:
                dv = c - com.to(d)[:, None, :]
                g2 = g2 + ((dv * dv).sum(dim=-1) * m[None, :]).sum(dim=1).to(first)
            coms.append(com)
            gyrs.append(torch.sqrt(g2 / msum))
        return torch.cat(coms), torch.cat(gyrs)

    return fn
