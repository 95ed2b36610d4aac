"""Port vs JAX package: exact Lee-Richards SASA, Shrake-Rupley and the SASA
workload, on the CPU.

Seeded numpy scenes (at most 400 atoms, 32 or 48 slices) go through
``molar_tpu.ops.sasa_lr`` / ``molar_tpu.ops.sasa`` on JAX-CPU and through
their counterparts in ``molar_tpu_torch.ops``. Tolerances: per-atom areas
within 1e-5 nm^2 of the JAX function (both are float32; ``arctan2``,
``arccos`` and the order of a sum differ by ulps, and equal ``lo`` keys
may sort differently, which moves a union length by an ulp) and within
1e-4 relative of the host float64 Lee-Richards (the bar of
``tests/test_sasa_lr.py``); device-built neighbour lists equal slot by
slot, overflow flags equal. The end-to-end runs of the ``sasa`` workload
against ``benchmarks/workloads.py``'s ``wl_sasa`` and the native C++
program are the ``sasa`` cases of ``tests/test_torch_workloads.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molar_tpu.ops import neighbor as jnb
from molar_tpu.ops import sasa as jsr
from molar_tpu.ops import sasa_host
from molar_tpu.ops import sasa_lr as jlr

from molar_tpu_torch import convert
from molar_tpu_torch import workloads as wl
from molar_tpu_torch.ops import sasa as tsr
from molar_tpu_torch.ops import sasa_lr as tlr
from molar_tpu_torch.tasks import trajectory as traj

ATOL = 1e-5  # nm^2 an atom, against the JAX function
HOST_RTOL = 1e-4


def _rel_err(dev, host):
    scale = np.maximum(np.abs(host), 1e-3)
    return np.max(np.abs(dev - host) / scale)


def _scene(name):
    """-> (coords f32 (n, 3), radii f32 (n,), extents) from a seed."""
    if name == "cluster60":
        rng = np.random.default_rng(5)
        return (rng.uniform(0, 1.2, (60, 3)).astype(np.float32),
                rng.uniform(0.15, 0.3, 60).astype(np.float32), (1.2, 1.2, 1.2))
    if name == "box300":
        rng = np.random.default_rng(19)
        return (rng.uniform(0.8, 3.2, (300, 3)).astype(np.float32),
                rng.uniform(0.25, 0.35, 300).astype(np.float32), (4.0, 4.0, 4.0))
    if name == "slab7.3":
        # An extent float32 does not hold exactly, atoms on the lower and
        # the upper faces of the box and one past it.
        rng = np.random.default_rng(23)
        c = rng.uniform(0, 1, (300, 3)) * (3.0, 3.0, 7.3)
        c[:6] = [(0, 0, 0), (3.0, 3.0, 7.3), (1.5, 3.0, 7.3), (3.0, 1.0, 0.0), (2.9999998, 1, 7.3),
                 (1.0, 1.0, 7.31)]
        return (c.astype(np.float32), rng.uniform(0.28, 0.33, 300).astype(np.float32),
                (3.0, 3.0, 7.3))
    if name == "wrapped":
        # A ring of neighbours on the -x side of each of a row of atoms:
        # every covering interval straddles +-pi, so all the second slots
        # start at lo = -pi exactly and the sort meets many equal keys.
        rng = np.random.default_rng(29)
        centres = np.stack([np.arange(8) * 2.0 + 1.0, np.full(8, 1.0), np.full(8, 1.0)], axis=1)
        ring = []
        for c in centres:
            ang = np.pi + rng.uniform(-0.5, 0.5, 12)
            z = rng.uniform(-0.25, 0.25, 12)
            ring.append(c + np.stack([0.35 * np.cos(ang), 0.35 * np.sin(ang), z], axis=1))
        coords = np.concatenate([centres, *ring]).astype(np.float32)
        return coords, np.full(len(coords), 0.31, np.float32), (17.0, 2.0, 2.0)
    raise KeyError(name)


SCENES = ["cluster60", "box300", "slab7.3", "wrapped"]


def _lists(coords, radii, cap=128):
    nbr, ofl = tlr.neighbor_lists(coords, radii, cap)
    assert not ofl
    return nbr


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_tf32_is_off_in_these_comparisons():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_public_names_of_the_jax_modules_are_all_there():
    for mine, theirs in ((tlr, jlr), (tsr, jsr)):
        public = [n for n, v in vars(theirs).items()
                  if not n.startswith("_") and getattr(v, "__module__", None) == theirs.__name__]
        public += ["DEFAULT_PROBE"]
        assert public and all(hasattr(mine, n) for n in public), public
    assert tlr.DEFAULT_PROBE == jlr.DEFAULT_PROBE and tsr.DEFAULT_PROBE == jsr.DEFAULT_PROBE


# ------------------------------------------------------------- host lists


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("skin", [0.0, 0.2])
def test_host_neighbor_lists_equal_the_jax_package(name, skin):
    coords, radii, _ = _scene(name)
    got, gofl = tlr.neighbor_lists(coords, radii, cap=192, skin=skin)
    want, wofl = jlr.neighbor_lists(coords.astype(np.float64), radii.astype(np.float64),
                                    cap=192, skin=skin)
    assert not gofl and not wofl
    np.testing.assert_array_equal(np.sort(got, axis=1), np.sort(want, axis=1))
    assert got.dtype == want.dtype == np.int32
    # Index order, pads at the end.
    live = got >= 0
    assert (np.diff(np.where(live, got, 1 << 30), axis=1) > 0)[live[:, 1:]].all()


def test_host_neighbor_lists_overflow_flag_and_empty_input():
    coords, radii = np.zeros((10, 3)), np.full(10, 0.3)
    got, ofl = tlr.neighbor_lists(coords, radii, cap=4)
    assert ofl and (got >= 0).all()
    assert jlr.neighbor_lists(coords, radii, cap=4)[1]
    empty, ofl = tlr.neighbor_lists(np.zeros((0, 3)), np.zeros(0), cap=4)
    assert empty.shape == (0, 4) and not ofl


def test_max_displacement_matches():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(50, 3)).astype(np.float32), rng.normal(size=(50, 3)).astype(np.float32)
    got = float(tlr.max_displacement(_t(a), _t(b)))
    assert abs(got - float(jlr.max_displacement(jnp.asarray(a), jnp.asarray(b)))) < 1e-6


# ------------------------------------------------------------------- sasa


@pytest.mark.parametrize("name", SCENES)
def test_sasa_matches_the_jax_function_and_the_host(name):
    coords, radii, _ = _scene(name)
    nbr = _lists(coords, radii)
    got = tlr.sasa(_t(coords), _t(radii), _t(nbr), n_slices=32).numpy()
    want = np.asarray(jlr.sasa(jnp.asarray(coords), jnp.asarray(radii), jnp.asarray(nbr),
                               n_slices=32, block=128))
    assert got.dtype == np.float32 and got.shape == (len(coords),)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    host = sasa_host.sasa(coords.astype(np.float64), radii.astype(np.float64), probe=0.0,
                          n_slices=32)
    assert _rel_err(got, host) < HOST_RTOL
    # A buried atom's 2 pi - union can come out an ulp below zero, as in JAX.
    assert got.sum() > 0 and (got > -1e-6).all()


def test_wrapped_scene_has_many_equal_lo_keys():
    # What the scene is for: at least 8 second-slot intervals a slice that
    # all start at -pi, on the ring's centre atoms.
    coords, radii, _ = _scene("wrapped")
    d = coords[8:20] - coords[0]
    theta, half = np.arctan2(d[:, 1], d[:, 0]), 0.6
    assert ((theta + half > np.pi) | (theta - half < -np.pi)).sum() >= 8


def test_two_spheres_analytic():
    r, d = 0.3, 0.4
    coords = np.array([[0, 0, 0], [d, 0, 0]], np.float32)
    radii = np.full(2, r, np.float32)
    nbr = _lists(coords, radii, cap=4)
    got = tlr.sasa(_t(coords), _t(radii), _t(nbr), n_slices=256).numpy()
    want = 4 * np.pi * r * r - 2 * np.pi * r * (r - d / 2)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_lone_and_buried_spheres():
    coords = np.array([[0, 0, 0], [5, 5, 5], [5.01, 5, 5]], np.float32)
    radii = np.array([0.3, 0.2, 0.6], np.float32)
    nbr = _lists(coords, radii, cap=4)
    got = tlr.sasa(_t(coords), _t(radii), _t(nbr), n_slices=64).numpy()
    np.testing.assert_allclose(got[0], 4 * np.pi * 0.09, rtol=1e-5)  # exact for a sphere
    assert got[1] == 0.0  # wholly inside its neighbour
    np.testing.assert_allclose(got[2], 4 * np.pi * 0.36, rtol=1e-5)


@pytest.mark.parametrize("block", [7, 64, 300, 1000])
def test_sasa_does_not_depend_on_the_block(block):
    coords, radii, _ = _scene("box300")
    nbr = _t(_lists(coords, radii))
    whole = tlr.sasa(_t(coords), _t(radii), nbr, n_slices=32)
    assert torch.equal(tlr.sasa(_t(coords), _t(radii), nbr, n_slices=32, block=block), whole)


def test_block_follows_the_element_budget(monkeypatch):
    assert tlr._row_block(None, 1 << 20, 32 * 2 * 176) == tlr.BLOCK_ELEMS // (32 * 2 * 176)
    assert tlr._row_block(None, 10, 64) == 10 and tlr._row_block(5, 10, 64) == 5
    monkeypatch.setattr(tlr, "BLOCK_ELEMS", 1)
    assert tlr._row_block(None, 10, 64) == 1
    coords, radii, _ = _scene("cluster60")
    nbr = _t(_lists(coords, radii))
    one_row = tlr.sasa(_t(coords), _t(radii), nbr, n_slices=32)
    monkeypatch.undo()
    assert torch.equal(one_row, tlr.sasa(_t(coords), _t(radii), nbr, n_slices=32))


@pytest.mark.parametrize("shared_lists", [True, False])
def test_sasa_takes_a_window_of_frames(shared_lists):
    coords, radii, _ = _scene("box300")
    rng = np.random.default_rng(1)
    window = np.stack([coords + rng.normal(0, 0.01, coords.shape).astype(np.float32) * k
                       for k in range(3)])
    if shared_lists:  # one skin list for the whole window
        lists = tlr.neighbor_lists(coords, radii, cap=192, skin=0.3)[0]
        per_frame = [lists] * 3
    else:
        per_frame = [_lists(c, radii) for c in window]
        lists = np.stack(per_frame)
    got = tlr.sasa(_t(window), _t(radii), _t(lists), n_slices=32)
    assert got.shape == (3, 300)
    for f in range(3):
        one = tlr.sasa(_t(window[f]), _t(radii), _t(per_frame[f]), n_slices=32)
        assert torch.equal(got[f], one)
    assert not torch.equal(got[0], got[2])


def test_verlet_skin_list_gives_the_fresh_list_areas():
    rng = np.random.default_rng(6)
    coords0 = rng.uniform(0, 2.0, (80, 3))
    radii = np.full(80, 0.25)
    skin = 0.2
    nbr, _ = tlr.neighbor_lists(coords0, radii, cap=96, skin=skin)
    coords1 = coords0 + rng.uniform(-1, 1, coords0.shape) * (skin / (2 * np.sqrt(3)) * 0.99)
    c1 = _t(coords1.astype(np.float32))
    assert float(tlr.max_displacement(c1, _t(coords0.astype(np.float32)))) < skin / 2
    fresh, _ = tlr.neighbor_lists(coords1, radii, cap=96)
    a = tlr.sasa(c1, _t(radii), _t(nbr), n_slices=32)
    b = tlr.sasa(c1, _t(radii), _t(fresh), n_slices=32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ------------------------------------------------------------ device lists


def _device_lists_both(coords, radii, extents, cell_cap, k_cap, skin=0.0):
    dims = jnb.grid_dims(extents, 2 * float(radii.max()) + skin)
    want, wofl = jlr.neighbor_lists_device(jnp.asarray(coords), jnp.asarray(radii), extents, dims,
                                           cell_cap, k_cap, 0, skin=skin)
    got, gofl = tlr.neighbor_lists_device(_t(coords), _t(radii), extents, dims, cell_cap, k_cap,
                                          0, skin=skin)
    return got, gofl, np.asarray(want), bool(wofl), dims


@pytest.mark.parametrize("name,cell_cap,k_cap", [
    ("cluster60", 64, 64), ("box300", 24, 64), ("slab7.3", 32, 64), ("wrapped", 16, 32)])
def test_device_lists_equal_the_jax_package_slot_by_slot(name, cell_cap, k_cap):
    coords, radii, extents = _scene(name)
    got, gofl, want, wofl, _ = _device_lists_both(coords, radii, extents, cell_cap, k_cap)
    assert not bool(gofl) and not wofl
    assert got.dtype == torch.int32 and got.shape == (len(coords), k_cap)
    np.testing.assert_array_equal(got.numpy(), want)
    # And the same members as the host's dense search, but for pairs that
    # touch (membership at |xi - xj| = ri + rj is float32 against float64).
    host = tlr.neighbor_lists(coords, radii, cap=k_cap)[0]
    diff = np.sort(got.numpy(), axis=1) != np.sort(host, axis=1)
    assert diff.sum() <= 2


def test_device_lists_with_a_skin_equal_the_jax_package():
    coords, radii, extents = _scene("box300")
    got, gofl, want, wofl, _ = _device_lists_both(coords, radii, extents, 40, 96, skin=0.2)
    assert not bool(gofl) and not wofl
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cell_cap,k_cap,why", [(4, 64, "cell"), (24, 8, "row"), (4, 8, "both")])
def test_device_lists_overflow_flags_equal_the_jax_package(cell_cap, k_cap, why):
    coords, radii, extents = _scene("box300")
    _, gofl, _, wofl, _ = _device_lists_both(coords, radii, extents, cell_cap, k_cap)
    assert bool(gofl) and wofl, why
    _, gofl, _, wofl, _ = _device_lists_both(coords, radii, extents, 24, 64)
    assert not bool(gofl) and not wofl


def test_device_lists_of_a_window_are_the_frames_lists_with_a_flag_a_frame(monkeypatch):
    coords, radii, extents = _scene("box300")
    rng = np.random.default_rng(2)
    window = np.stack([coords] + [coords + rng.normal(0, 0.02, coords.shape).astype(np.float32)
                                  for _ in range(3)])
    # Frame 2 alone crowds one cell past its capacity.
    window[2, :30] = window[2, 0] + rng.uniform(-0.01, 0.01, (30, 3)).astype(np.float32)
    dims = jnb.grid_dims(extents, 2 * float(radii.max()))
    got, ofl = tlr.neighbor_lists_device(_t(window), _t(radii), extents, dims, 24, 64)
    assert got.shape == (4, 300, 64) and ofl.tolist() == [False, False, True, False]
    for f in (0, 1, 3):
        one, one_ofl = tlr.neighbor_lists_device(_t(window[f]), _t(radii), extents, dims, 24, 64)
        assert torch.equal(got[f], one) and not bool(one_ofl)
    # Cut into blocks of frames by the element budget: the same lists.
    monkeypatch.setattr(tlr, "BLOCK_ELEMS", 300 * 27 * 24)
    cut, cut_ofl = tlr.neighbor_lists_device(_t(window), _t(radii), extents, dims, 24, 64)
    assert torch.equal(cut_ofl, ofl)
    assert all(torch.equal(cut[f], got[f]) for f in (0, 1, 3))


def test_device_lists_of_no_atoms():
    got, ofl = tlr.neighbor_lists_device(torch.zeros(0, 3), torch.zeros(0), (1.0, 1.0, 1.0),
                                         (1, 1, 1), 4, 4)
    assert got.shape == (0, 4) and not bool(ofl)


@pytest.mark.parametrize("name,cell_cap,k_cap", [("box300", 24, 64), ("slab7.3", 32, 64)])
def test_sasa_window_matches_the_jax_package_and_the_frames(name, cell_cap, k_cap):
    coords, radii, extents = _scene(name)
    rng = np.random.default_rng(4)
    window = np.clip(np.stack([coords + rng.normal(0, 0.01, coords.shape).astype(np.float32) * k
                               for k in range(3)]), 0, None).astype(np.float32)
    dims = jnb.grid_dims(extents, 2 * float(radii.max()))
    got, ofl = tlr.sasa_window(_t(window), _t(radii), extents, dims, cell_cap, k_cap,
                               n_slices=32)
    want, wofl = jlr.sasa_window(jnp.asarray(window), jnp.asarray(radii), extents, dims,
                                 cell_cap, k_cap, 0, n_slices=32, block=128)
    assert not ofl.any() and not np.asarray(wofl).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for f in range(3):
        nbr, _ = tlr.neighbor_lists_device(_t(window[f]), _t(radii), extents, dims, cell_cap,
                                           k_cap)
        assert torch.equal(got[f], tlr.sasa(_t(window[f]), _t(radii), nbr, n_slices=32))
        # The device-built lists give the host-built lists' areas.
        host = tlr.sasa(_t(window[f]), _t(radii), _t(_lists(window[f], radii)), n_slices=32)
        np.testing.assert_allclose(got[f].numpy(), host.numpy(), atol=1e-6)


# ------------------------------------------------------------------ banded


@pytest.mark.parametrize("n_bands", [4, 8])
def test_sasa_banded_matches_sasa_and_the_jax_package(n_bands):
    coords, radii, _ = _scene("box300")
    skin = 0.1
    nbr = tlr.neighbor_lists(coords, radii, cap=128, skin=skin)[0]
    got_b = tlr.band_neighbor_lists(coords, radii, nbr, 32, n_bands=n_bands, skin=skin)
    want_b = jlr.band_neighbor_lists(coords, radii, nbr, 32, n_bands=n_bands, skin=skin)
    for g, w in zip(got_b, want_b):
        np.testing.assert_array_equal(g, w)
    nbz, starts, w, g = got_b
    assert g == n_bands and w % 32 == 0 and w < nbr.shape[1] + 32
    banded = tlr.sasa_banded(_t(coords), _t(radii), _t(nbz), _t(starts), w, g, n_slices=32)
    plain = tlr.sasa(_t(coords), _t(radii), _t(nbr), n_slices=32)
    np.testing.assert_allclose(banded.numpy(), plain.numpy(), atol=2e-6, rtol=0)
    if n_bands == 8:  # one JAX compile of the banded program is enough
        want = np.asarray(jlr.sasa_banded(jnp.asarray(coords), jnp.asarray(radii),
                                          jnp.asarray(nbz), jnp.asarray(starts), w, g,
                                          n_slices=32, block=100))
        np.testing.assert_allclose(banded.numpy(), want, atol=ATOL, rtol=0)
    cut = tlr.sasa_banded(_t(coords), _t(radii), _t(nbz), _t(starts), w, g, n_slices=32, block=77)
    assert torch.equal(cut, banded)


def test_sasa_banded_needs_slices_that_divide_into_bands():
    with pytest.raises(ValueError, match="divide"):
        tlr.sasa_banded(torch.zeros(2, 3), torch.ones(2), torch.zeros(2, 40, dtype=torch.int32),
                        torch.zeros(2, 5, dtype=torch.int32), 32, 5, n_slices=32)


# ------------------------------------------------------------------ series


def test_sasa_series_host_mode_stays_exact_across_rebuilds():
    rng = np.random.default_rng(11)
    c = rng.uniform(0, 1.5, (50, 3))
    vdw = np.full(50, 0.15)
    ss = tlr.SasaSeries(c, vdw, probe=0.14, skin=0.1, n_slices=32, cap=4, device="cpu")
    assert ss.cap > 4  # the first build outgrew its capacity
    for k in range(5):
        c = c + rng.normal(0, 0.04, c.shape)
        got = ss.update(c).numpy()
        want = sasa_host.sasa(c, vdw, probe=0.14, n_slices=32)
        assert _rel_err(got, want) < HOST_RTOL, k
    assert ss.rebuilds >= 1
    assert torch.equal(ss.areas(c), ss.update(c))


@pytest.mark.parametrize("how", ["extents", "box"])
def test_sasa_series_device_mode_sizes_its_caps_as_the_jax_package(how):
    coords, radii, extents = _scene("box300")
    vdw = radii.astype(np.float64) - 0.14
    kw = {"extents": extents} if how == "extents" else {"box": np.diag(extents)}
    ss = tlr.SasaSeries(coords, vdw, n_slices=32, device="cpu", **kw)
    ref = jlr.SasaSeries(coords, vdw, n_slices=32, block=100, **kw)
    assert (ss._k_cap, ss._cell_cap, ss._dims) == (ref._k_cap, ref._cell_cap, ref._dims)
    got = ss.update(coords).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.update(coords)), atol=ATOL, rtol=0)
    assert _rel_err(got, sasa_host.sasa(coords.astype(np.float64), vdw, probe=0.14,
                                        n_slices=32)) < HOST_RTOL
    assert ss.rebuilds == 0


def test_sasa_series_device_mode_escalates_its_caps_on_overflow():
    coords, radii, extents = _scene("box300")
    vdw = radii.astype(np.float64) - 0.14
    ss = tlr.SasaSeries(coords, vdw, n_slices=32, extents=extents, device="cpu")
    want = ss.update(coords)
    k_cap, cell_cap = ss._k_cap, ss._cell_cap
    ss._k_cap, ss._cell_cap = 16, 8  # forced: both far too small
    got = ss.update(coords)
    assert ss.rebuilds >= 2 and ss._k_cap > 16 and ss._cell_cap > 8
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert (ss._k_cap * 3 // 2 + 15) // 16 * 16 >= k_cap or ss._k_cap <= k_cap * 2


def test_sasa_series_triclinic_box_falls_back_to_host_mode_and_needs_a_device():
    rng = np.random.default_rng(2)
    c = rng.uniform(0, 1.0, (20, 3))
    skewed = np.array([[2.0, 0, 1.0], [0, 2.0, 1.0], [0, 0, 1.4]])
    ss = tlr.SasaSeries(c, np.full(20, 0.15), box=skewed, n_slices=32, device="cpu")
    assert ss.extents is None and ss.update(c).shape == (20,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlr.SasaSeries(c, np.full(20, 0.15))


# ----------------------------------------------------------- Shrake-Rupley


def test_fibonacci_sphere_equals_the_jax_package():
    for n in (1, 17, 960):
        np.testing.assert_array_equal(tsr.fibonacci_sphere(n), jsr.fibonacci_sphere(n))


@pytest.mark.parametrize("name", ["cluster60", "box300"])
def test_neighbor_matrix_has_the_jax_package_members(name):
    coords, radii, _ = _scene(name)
    got, gofl = tsr.neighbor_matrix(coords, radii, cap=128)
    want, wofl = jsr.neighbor_matrix(coords.astype(np.float64), radii.astype(np.float64), cap=128)
    assert not gofl and not wofl and got.dtype == want.dtype
    np.testing.assert_array_equal(np.sort(got, axis=1), np.sort(want, axis=1))
    assert tsr.neighbor_matrix(coords, radii, cap=2)[1]


@pytest.mark.parametrize("name", ["cluster60", "box300"])
def test_shrake_rupley_matches_the_jax_function(name):
    coords, radii, _ = _scene(name)
    nbm, _ = tsr.neighbor_matrix(coords, radii, cap=128)
    got = tsr.shrake_rupley(_t(coords), _t(radii), _t(nbm), n_points=240).numpy()
    want = np.asarray(jsr.shrake_rupley(jnp.asarray(coords), jnp.asarray(radii),
                                        jnp.asarray(nbm), n_points=240))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # The sampled areas approach the exact ones.
    exact = tlr.sasa(_t(coords), _t(radii), _t(_lists(coords, radii)), n_slices=48).numpy()
    assert abs(got.sum() - exact.sum()) < 0.03 * exact.sum()


def test_shrake_rupley_takes_a_window_of_frames():
    coords, radii, _ = _scene("cluster60")
    nbm, _ = tsr.neighbor_matrix(coords, radii, cap=128)
    window = np.stack([coords, coords + np.float32(0.003)])
    got = tsr.shrake_rupley(_t(window), _t(radii), _t(nbm), n_points=96)
    want = np.asarray(jsr.shrake_rupley(jnp.asarray(window), jnp.asarray(radii),
                                        jnp.asarray(nbm), n_points=96))
    assert got.shape == (2, 60)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert torch.equal(got[0], tsr.shrake_rupley(_t(coords), _t(radii), _t(nbm), n_points=96))


# ------------------------------------------------------------ the workload


N_ATOMS, N_PROTEIN, N_FRAMES = 2000, 400, 12


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    system = wl.synth_system(N_ATOMS, N_PROTEIN)
    xtc = str(tmp_path_factory.mktemp("sasa") / "traj.xtc")
    wl.write_xtc(system, xtc, N_FRAMES)
    return system, xtc


def test_sasa_workload_is_built_as_wl_sasa_builds_it(case):
    system, _ = case
    model, subset = convert.workload_from_numpy("sasa", system, "cpu")
    np.testing.assert_array_equal(subset, system.protein)
    radii = wl.sasa_radii(N_PROTEIN)
    assert radii.dtype == np.float64 and model.radii.dtype == torch.float32
    np.testing.assert_array_equal(model.radii.numpy(), radii.astype(np.float32))
    assert model.extents == (8.0, 8.0, 8.0) and model.n_slices == 32 == wl.SASA_SLICES
    assert model.dims == jnb.grid_dims(model.extents, 2 * float(radii.max())) == (12, 12, 12)
    c0 = system.coords[system.protein].astype(np.float64)
    nb0, _ = jlr.neighbor_lists(c0, radii, cap=1024, skin=0.0)
    cell0, _, _ = jnb.estimate_caps(c0, np.diag([1 / 8.0] * 3), model.dims, margin=1.0,
                                    round_to=1)
    assert (model.k0, model.cell0) == (int((nb0 >= 0).sum(1).max()), cell0)
    for tier in range(3):
        g = 1.5**tier
        want = ((int(model.k0 * 1.25 * g) + 15) // 16 * 16,
                (int(model.cell0 * 1.25 * g) + 7) // 8 * 8)
        assert wl.sasa_caps(model.k0, model.cell0, tier) == want
        at = model.at_tier(tier)
        assert (at.k_cap, at.cell_cap, at.tier) == (*want, tier) and at.radii is model.radii


def test_sasa_workload_per_residue_areas_match_the_jax_functions(case):
    system, xtc = case
    model, subset = convert.workload_from_numpy("sasa", system, "cpu")
    pipe = traj.WindowPipeline(traj.TrajectoryReader([xtc]), 5, model, "cpu", quantized="delta",
                               subset=subset)
    outs = [res for _, res in pipe.run()]
    areas = torch.cat([o[0] for o in outs]).numpy()
    assert areas.shape == (N_FRAMES, N_PROTEIN // 4)
    assert not torch.cat([o[1] for o in outs]).any()
    (coords, *_), = traj.TrajectoryReader([xtc]).iter_windows(N_FRAMES, subset=subset)
    radii = jnp.asarray(wl.sasa_radii(N_PROTEIN), jnp.float32)
    seg = jnp.asarray(system.segment_ids)
    for f in (0, N_FRAMES - 1):
        nbr, ofl = jlr.neighbor_lists_device(jnp.asarray(coords[f]), radii, model.extents,
                                             model.dims, model.cell_cap, model.k_cap, 0)
        per_atom = jlr.sasa(jnp.asarray(coords[f]), radii, nbr, n_slices=32, block=400)
        want = np.asarray(jax.ops.segment_sum(per_atom, seg, num_segments=N_PROTEIN // 4))
        assert not bool(ofl)
        np.testing.assert_allclose(areas[f], want, atol=4 * ATOL, rtol=0)


def test_sasa_workload_escalates_tiers_window_by_window(case, monkeypatch):
    system, xtc = case
    n, _, want = wl.run("sasa", system, xtc, 5, "cpu")
    assert n == N_FRAMES and want["check"] > 0
    real, built = wl.sasa_caps, []

    def small_at_tier0(k0, cell0, tier):
        built.append(tier)
        return (1, 1) if tier == 0 else real(k0, cell0, tier)

    monkeypatch.setattr(wl, "sasa_caps", small_at_tier0)
    n, _, got = wl.run("sasa", system, xtc, 5, "cpu")
    assert n == N_FRAMES and 1 in built and 2 not in built
    # Tier 1's larger lists hold the same neighbours: the same areas.
    assert abs(got["check"] - want["check"]) <= 1e-6 * want["check"]


def test_sasa_workload_raises_when_the_last_tier_overflows(case, monkeypatch):
    system, xtc = case
    monkeypatch.setattr(wl, "sasa_caps", lambda k0, cell0, tier: (1, 1))
    with pytest.raises(traj.AnalysisError, match="largest capacity tier 2"):
        wl.run("sasa", system, xtc, 5, "cpu")


def test_sasa_checks_raise_on_a_frame_without_area_and_on_an_overflow():
    areas = torch.ones(3, 5)
    clear = torch.zeros(3, dtype=torch.bool)
    assert wl._checks("sasa", [(areas, clear)]) == {"check": 5.0}
    areas[1] = 0
    with pytest.raises(traj.AnalysisError, match="without area"):
        wl._checks("sasa", [(areas, clear)])
    with pytest.raises(traj.AnalysisError, match="overflowed"):
        wl._checks("sasa", [(torch.ones(3, 5), torch.tensor([False, True, False]))])


def test_sasa_window_default_is_used_when_none_is_asked_for(case, monkeypatch):
    system, xtc = case
    seen = []
    real = traj.run_with_overflow_retry

    def spy(reader, window, *a, **kw):
        seen.append(window)
        return real(reader, window, *a, **kw)

    monkeypatch.setattr(wl, "run_with_overflow_retry", spy)
    wl.run("sasa", system, xtc, 0, "cpu")
    wl.run("sasa", system, xtc, 6, "cpu")
    assert seen == [wl.SASA_WINDOW, 6]
