"""The work the membrane analysis's roofline owes a window, counted from the
frames alone (their head markers and the patches those give), so that the
count is the same whatever implements the analysis.

Operations a frame, float operations and compares counted from the
analysis's arithmetic (gathers, sorts and the selection of a patch not):

* the patch search: the candidate pairs of a periodic cell grid of the head
  markers whose cells are at least a cutoff high, as a ``within`` search
  owes them (``work.candidate_pairs``), 9 each;
* each patch member of each lipid: the normal's two averaging passes (a
  dot product, its sign and a sum: 9 each), the fit (the minimum-image
  displacement 12, the local frame 15, the design row 5 and its share of
  the normal equations, 21 products and 6 right-hand sides summed: 54)
  and the Voronoi cut by its bisector (the line 5, the side of the cell's
  vertices, about 6 of them, 18, two crossings 12): 138;
* each lipid: the local frame and its inverse 60, the Cholesky solve 150,
  the curvatures and the normal 40, the lifted cell's area 180: 430; the
  unwrap of the atoms the analysis reads (head, tail ends and tail
  carbons: difference, minimum image, sum) 15 an atom; and each order
  parameter (the local frame of a carbon and three angles) 60.

Bytes: the atoms the analysis reads (each lipid's head and tail carbons,
as the membrane's TOML names them), read once as i16 coordinates (6 bytes
an atom a frame), the window's boxes and their inverses, and the results
written once: a lipid's validity, area, two curvatures, normal, tail-head
vector and patch count (41 bytes), its order parameters (4 bytes each)
and a neighbour id and flag for each patch member (5 bytes). Rows that a
program ships and the analysis does not read are not counted.
"""

from __future__ import annotations

import numpy as np

from ..frozen import bounds
from ..reference import membrane as ref_membrane
from . import work

FLOPS_PER_PATCH_SLOT = 138
FLOPS_PER_LIPID = 430
FLOPS_PER_UNWRAPPED_ATOM = 15
FLOPS_PER_ORDER_VALUE = 60
BYTES_PER_LIPID = 41
BYTES_PER_ORDER_VALUE = 4
BYTES_PER_PATCH_SLOT = 5
BYTES_PER_READ_ATOM = 6
BYTES_PER_FRAME_BOXES = 2 * 9 * 4


def window_work(heads, sides, cutoff: float, read_atoms: int, order_values: int) -> dict:
    """FLOPs and bytes of one window: ``heads`` (B, L, 3) float64 tensors
    of its head markers, ``sides`` (3,) the orthorhombic box,
    ``read_atoms`` and ``order_values`` a lipid's atoms the analysis reads
    and order parameters it computes."""
    b, n_lipids = heads.shape[:2]
    slots = 0
    for x in heads:
        adj, _ = ref_membrane.patches(x, sides, cutoff, 0.0)
        slots += int(adj.sum())
    box = np.diag(sides.cpu().numpy())
    pairs = work.candidate_pairs(heads.cpu().numpy(), box, np.arange(n_lipids), cutoff)
    lipid_frames = b * n_lipids
    flops = (bounds.FLOPS_PER_CANDIDATE_PAIR * pairs + FLOPS_PER_PATCH_SLOT * slots
             + lipid_frames * (FLOPS_PER_LIPID + FLOPS_PER_UNWRAPPED_ATOM * read_atoms
                               + FLOPS_PER_ORDER_VALUE * order_values))
    nbytes = (b * BYTES_PER_FRAME_BOXES
              + lipid_frames * (BYTES_PER_READ_ATOM * read_atoms + BYTES_PER_LIPID
                                + BYTES_PER_ORDER_VALUE * order_values)
              + BYTES_PER_PATCH_SLOT * slots)
    return {"flops": flops, "bytes": nbytes, "items": slots}
