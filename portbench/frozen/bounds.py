"""The table of peaks and the per-item operation counts of the rooflines.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F32_FLOP_PER_S`` and
the bound arithmetic of its ghost-stencil and SASA phases), so that the
yardstick stays where later changes to the program cannot move it.
"""

#: Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): device
#: memory bytes/s, and float32 FLOP/s outside the tensor cores (the
#: kernels' arithmetic type).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

#: Operations of one candidate pair of a within search: three differences,
#: three products, two sums and the compare against the squared cutoff.
FLOPS_PER_CANDIDATE_PAIR = 9

#: Operations of one (atom, neighbour, slice) triple of Lee-Richards SASA:
#: the neighbour's slice circle, the overlap tests, the covered arc and its
#: two wrap slots.
FLOPS_PER_SASA_TRIPLE = 48


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for the work, and which peak
    bounds it."""
    t_flops = flops / F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_flops, "f32_flops") if t_flops >= t_bytes else (t_bytes, "hbm_bytes")
