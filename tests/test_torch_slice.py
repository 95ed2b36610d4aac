"""Port vs JAX package: the whole headline slice at a small size.

A 5k-atom system (500 "protein" atoms, the headline's density) is written as
a 16-frame XTC and streamed in windows of 8 i8-delta frames, once through
the port (``headline.run``: ``FitWithinWindow`` under
``run_with_overflow_retry``) and once through the JAX package with the
headline's window function (``bench.py``'s ``window_fn``: decode, per-frame
Kabsch RMSD, sparse-target ``within_mask``, uint32 checksum, ``lax.scan``).
Counts and checksums must be identical and RMSDs agree to 1e-5; tier-0
capacities that are too small must be retried to the same result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molar_tpu.core.pbc import PBC_FULL
from molar_tpu.core.pbc import PeriodicBox as JaxBox
from molar_tpu.io.xtc import XtcHandler as JaxXtc
from molar_tpu.ops import measure as jmeasure
from molar_tpu.ops import neighbor as jnb
from molar_tpu.ops import neighbor_host
from molar_tpu.tasks import trajectory as jtraj

from molar_tpu_torch import convert, headline
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.ops.neighbor import grid_dims_for
from molar_tpu_torch.tasks.trajectory import TrajectoryReader

N_ATOMS, N_PROTEIN, N_FRAMES, WINDOW, CUTOFF = 5000, 500, 16, 8, 0.5
SIDE = 10.0 * (N_ATOMS / 100_000) ** (1 / 3)  # the headline's 100 atoms/nm^3


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    coords0, masses = headline.make_system(N_ATOMS, N_PROTEIN, np.diag([SIDE] * 3))
    box = PeriodicBox(np.diag([SIDE] * 3))
    path = str(tmp_path_factory.mktemp("slice") / "traj.xtc")
    headline.write_trajectory(path, coords0, box.matrix, N_FRAMES)
    pidx = np.arange(N_PROTEIN)
    dims = grid_dims_for(box, CUTOFF)
    caps0 = headline.base_caps(path, box.inv, dims, pidx)
    with JaxXtc(path) as h:
        first = h.read_frame(0).coords
    return dict(path=path, first=first, coords0=coords0, masses=masses, box=box, pidx=pidx,
                dims=dims, caps0=caps0)


def _jax_headline(s):
    """``bench.py``'s window function and retry loop, on JAX-CPU."""
    cap0, tcap0, need_cells0 = jnb.estimate_caps(
        s["first"], s["box"].inv, s["dims"], s["pidx"],
        margin=1.0, round_to=1)
    assert (cap0, tcap0, need_cells0) == s["caps0"]
    pidx_j = jnp.asarray(s["pidx"])
    aidx_j = jnp.arange(N_ATOMS)
    ref_j = jnp.asarray(s["coords0"][s["pidx"]])
    pm_j = jnp.asarray(s["masses"][s["pidx"]])

    def build_fn(tier):
        g = 1.5**tier
        cap = (int(cap0 * 1.2 * g) + 2 + 7) // 8 * 8
        tcap = (int(tcap0 * 1.2 * g) + 2 + 7) // 8 * 8
        cells = max(512, (int(need_cells0 * 1.25 * g) + 255) // 256 * 256)

        @jax.jit
        def window_fn(coords, boxes, invs, times):
            coords = jtraj.decode_window_coords(coords)

            def per_frame(carry, frame):
                c, b, i = frame
                sel = jnp.stack([c[:, 0][pidx_j], c[:, 1][pidx_j], c[:, 2][pidx_j]], axis=-1)
                rmsd, _, _ = jmeasure.fit_rmsd(sel, ref_j, pm_j)
                mask, overflow = jnb.within_mask(
                    c, None, pidx_j, cutoff=CUTOFF, box=b, inv=i, dims=s["dims"],
                    cap=cap, tgt_cap=tcap, max_tgt_cells=cells)
                chk = jnp.sum(jnp.where(mask, (aidx_j + 1).astype(jnp.uint32), 0),
                              dtype=jnp.uint32)
                return carry, (rmsd, jnp.sum(mask), chk, overflow)

            _, out = jax.lax.scan(per_frame, 0, (coords, boxes, invs))
            return out

        return window_fn

    results, _ = jtraj.run_with_overflow_retry(
        jtraj.TrajectoryReader([s["path"]]), WINDOW, build_fn, n_tiers=4,
        overflow_of=lambda r: r[3], quantized="delta")
    ids = np.concatenate([i for i, _ in results])
    return ids, *(np.concatenate([np.asarray(r[k]) for _, r in results]) for k in range(3))


@pytest.fixture(scope="module")
def jax_result(system):
    return _jax_headline(system)


def _port_run(s, caps0=None):
    return headline.run(s["path"], s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"],
                        s["box"], CUTOFF, s["dims"], caps0 or s["caps0"], WINDOW, "cpu")


def _assert_same(port, jax_result):
    ids, rmsd, count, check = port
    jids, jrmsd, jcount, jcheck = jax_result
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(count, jcount)
    np.testing.assert_array_equal(check, jcheck.astype(np.int64))
    np.testing.assert_allclose(rmsd, jrmsd, atol=1e-5, rtol=0)


def test_headline_matches_jax_window_fn(system, jax_result):
    ids, rmsd, count, check, retried = _port_run(system)
    assert retried == 0 and len(ids) == N_FRAMES
    assert check.dtype == np.int64 and (check >= 0).all() and (check < 2**32).all()
    _assert_same((ids, rmsd, count, check), jax_result)


def test_headline_matches_host_search(system):
    ids, rmsd, count, check, _ = _port_run(system)
    box = JaxBox(system["box"].matrix)
    with JaxXtc(system["path"]) as h:
        for k in (0, N_FRAMES // 2, N_FRAMES - 1):
            st = h.read_frame(k)
            want = neighbor_host.search_within(
                CUTOFF, st.coords, np.arange(N_ATOMS), system["pidx"], box, PBC_FULL)
            assert count[k] == len(want)
            assert check[k] == int(np.sum(want.astype(np.uint32) + np.uint32(1), dtype=np.uint32))


def test_overflow_retry_reaches_the_same_result(system, jax_result):
    cap0, tcap0, cells0 = system["caps0"]
    small = (cap0 // 3, tcap0 // 3, cells0)
    assert headline.caps_for(*small, 0)[0] < cap0  # tier 0 must overflow
    ids, rmsd, count, check, retried = _port_run(system, caps0=small)
    assert retried == N_FRAMES // WINDOW
    _assert_same((ids, rmsd, count, check), jax_result)


def test_window_transports_give_identical_results(system):
    s = system
    model = convert.from_numpy(s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"],
                               s["box"].matrix, CUTOFF, headline.caps_for(*s["caps0"], 0),
                               s["dims"], "cpu")
    outs = []
    for quantized in (False, True, "delta"):
        window = next(iter(TrajectoryReader([s["path"]]).iter_windows(WINDOW, quantized)))
        outs.append(model(*convert.transport_to_torch(window, "cpu")))
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)
    rmsd, count, check, ofl = outs[0]
    assert rmsd.shape == count.shape == check.shape == ofl.shape == (WINDOW,)
    assert not ofl.any()


def test_caps_for_follows_bench_tiers():
    for cap0, tcap0, cells0 in ((39, 24, 350), (53, 7, 1), (1, 1, 900)):
        for tier in range(4):
            g = 1.5**tier
            want = ((int(cap0 * 1.2 * g) + 2 + 7) // 8 * 8, (int(tcap0 * 1.2 * g) + 2 + 7) // 8 * 8,
                    max(512, (int(cells0 * 1.25 * g) + 255) // 256 * 256))
            assert headline.caps_for(cap0, tcap0, cells0, tier) == want


def test_from_numpy_builds_buffers_and_rejects_triclinic(system):
    """The buffers and the route: a skewed box is never handed to the
    orthorhombic row kernel, nor to the ghost kernels on a grid finer than
    its cell heights (it takes the correction path); on the height-sized
    grid it keeps the ghost route. An unknown search is rejected."""
    s = system
    args = (s["coords0"][s["pidx"]], s["masses"][s["pidx"]], s["pidx"])
    model = convert.from_numpy(*args, s["box"].matrix, CUTOFF, (48, 32, 512), s["dims"], "cpu")
    assert {n for n, _ in model.named_buffers()} == {"ref", "masses", "protein_idx"}
    assert model.ref.dtype == torch.float32 and model.protein_idx.dtype == torch.int64
    assert (model.cap, model.tgt_cap, model.dims) == (48, 32, s["dims"])
    assert model.search == "ghost"
    rows = convert.from_numpy(*args, s["box"].matrix, CUTOFF, (48, 32, 512), s["dims"], "cpu",
                              search="rows")
    assert rows.search == "rows"
    skew = s["box"].matrix.copy()
    skew[0, 1] = 0.3
    assert grid_dims_for(PeriodicBox(skew), CUTOFF) == s["dims"]
    finer = tuple(d + 1 for d in s["dims"])
    for search, dims in (("ghost", finer), ("rows", s["dims"]), ("corrections", s["dims"])):
        tric = convert.from_numpy(*args, skew, CUTOFF, (48, 32, 768), dims, "cpu",
                                  search=search)
        assert (tric.search, tric.max_tgt_cells) == ("corrections", 768)
        assert {n for n, _ in tric.named_buffers()} == {"ref", "masses", "protein_idx", "ijk"}
    kept = convert.from_numpy(*args, skew, CUTOFF, (48, 32, 768), s["dims"], "cpu")
    assert kept.search == "ghost" and kept.skewed
    assert {n for n, _ in kept.named_buffers()} == {"ref", "masses", "protein_idx"}
    with pytest.raises(ValueError):
        convert.from_numpy(*args, s["box"].matrix, CUTOFF, (48, 32, 512), s["dims"], "cpu",
                           search="dense")
