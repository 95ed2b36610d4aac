"""The ghost-slab 27-cell stencil: the hand-written CUDA kernel and its plain twin.

Counterpart of ``molar_tpu.ops.neighbor_pallas.within_ghost_pallas``'s
kernel. The planes are built by :mod:`.neighbor` (sort + scatter in torch);
the stencil over them runs in ``csrc/within_ghost.cu``, built by
:mod:`molar_tpu_torch.build` and bound with ctypes (plain C entry point,
pointers and the stream as ``c_void_p``).

:func:`within_ghost` launches the kernel for CUDA tensors and never falls
back: a build failure, a refused launch or an unsupported input raises. For
CPU tensors, and only for them, it runs the plain twin :func:`_ghost_stencil`.
``within_ghost.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

_vp = ctypes.c_void_p
_int = ctypes.c_int

_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


@functools.cache
def _lib() -> ctypes.CDLL:
    path, _ = build.build_kernels()
    lib = ctypes.CDLL(str(path))
    lib.within_ghost_launch.restype = _int
    lib.within_ghost_launch.argtypes = [
        _vp, _vp, _vp,  # source planes x, y, z (n_cells, cap)
        _vp, _vp, _vp,  # ghost target planes x, y, z (nx+2, ny+2, nz+2, tgt_cap)
        _vp,            # hit out (n_cells, cap) bool
        _int, _int, _int, _int, _int,  # nx, ny, nz, cap, tgt_cap
        ctypes.c_float,  # cutoff^2
        _vp,            # cudaStream_t
    ]
    lib.within_ghost_error_string.restype = ctypes.c_char_p
    lib.within_ghost_error_string.argtypes = [_int]
    return lib


def _check(kernel, name, t, device, shape):
    """Raise unless plane ``name`` of ``kernel``'s inputs is a contiguous
    float32 tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{kernel}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _ghost_stencil(src, ghost, dims, cap: int, tgt_cap: int, c2: float):
    """Plain 27-cell stencil over the planes -> hit blocks ``(n_cells, cap)``.

    One ``(n_cells, cap, tgt_cap)`` distance block per offset, the target
    block a contiguous slice of the ghost planes. The plain twin of the CUDA
    kernel (same operands, same rounding order ``(dx² + dy²) + dz²``).
    """
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    sxb3, syb3, szb3 = (s[:, :, None] for s in src)
    gx, gy, gz = ghost
    hit = torch.zeros(sxb3.shape[:2], dtype=torch.bool, device=sxb3.device)
    for ox, oy, oz in _OFFSETS:
        a, b, c = ox + 1, oy + 1, oz + 1
        ntx = gx[a: a + nx, b: b + ny, c: c + nz].reshape(n_cells, 1, tgt_cap)
        nty = gy[a: a + nx, b: b + ny, c: c + nz].reshape(n_cells, 1, tgt_cap)
        ntz = gz[a: a + nx, b: b + ny, c: c + nz].reshape(n_cells, 1, tgt_cap)
        dx = ntx - sxb3
        dy = nty - syb3
        dz = ntz - szb3
        d2 = dx * dx + dy * dy + dz * dz
        hit |= (d2 <= c2).any(dim=2)
    return hit


def within_ghost(src, ghost, dims, cap: int, tgt_cap: int, c2: float):
    """27-cell stencil -> hit blocks ``(n_cells, cap)`` bool.

    ``src``: source planes x, y, z ``(n_cells, cap)``; ``ghost``: target
    planes x, y, z ``(nx+2, ny+2, nz+2, tgt_cap)``; ``c2``: the squared
    cutoff, an f32 value. CUDA planes go to the kernel, CPU planes to
    :func:`_ghost_stencil`; any other device raises.
    """
    nx, ny, nz = dims
    if min(dims) < 1 or cap < 1 or tgt_cap < 1:
        raise ValueError(f"within_ghost: bad sizes dims={dims} cap={cap} tgt_cap={tgt_cap}")
    device = src[0].device
    if device.type == "cpu":
        return _ghost_stencil(src, ghost, dims, cap, tgt_cap, c2)
    if device.type != "cuda":
        raise ValueError(f"within_ghost: the kernel takes CUDA tensors, got {device}")
    for name, t in zip(("sx", "sy", "sz"), src):
        _check("within_ghost", name, t, device, (nx * ny * nz, cap))
    for name, t in zip(("gx", "gy", "gz"), ghost):
        _check("within_ghost", name, t, device, (nx + 2, ny + 2, nz + 2, tgt_cap))
    lib = _lib()
    hit = torch.empty((nx * ny * nz, cap), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        err = lib.within_ghost_launch(
            *(t.data_ptr() for t in src),
            *(t.data_ptr() for t in ghost),
            hit.data_ptr(),
            nx, ny, nz, cap, tgt_cap, c2,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"within_ghost kernel launch failed: {lib.within_ghost_error_string(err).decode()}"
        )
    within_ghost.launches += 1
    return hit


within_ghost.launches = 0
