"""Port vs JAX package: the membrane pipeline (``membrane/device.py``).

Each scene is one bilayer of ``test_membrane_device.make_bilayer`` (at most
50 lipids) with the options of its ``TOML``, built once: the reference
``MembraneDevice`` on JAX-CPU, the port's ``MembraneDevice`` on CPU tensors
from the same static structure (``convert.membrane_from_reference``), and,
where the reference's own tests do, the host ``Membrane`` frame by frame.

Against the JAX device path: ``valid``, ``overflow``, ``n_neighbors``,
``patch_cap`` and the neighbour id sets equal; ``area``, ``normal``, ``thv``
and ``order`` within 1e-5 (relative, atol 1e-6); ``mean_curv`` and
``gauss_curv`` within 1e-4 relative and 1e-5 absolute. Against the host
pipeline: the reference's own bars (``test_membrane_device.py``). The group
statistics of ``accumulate`` against the reference's, their files byte for
byte. The building blocks alone. The membrane workload against
``wl_membrane(device=True)`` on JAX-CPU and ``native_membrane.cpp``.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molar_tpu import PeriodicBox as RefBox
from molar_tpu.membrane import Membrane
from molar_tpu.membrane import device as jdev
from molar_tpu.membrane.device import MembraneDevice as RefDevice

from molar_tpu_torch import convert
from molar_tpu_torch import workloads as wl
from molar_tpu_torch.membrane import (
    MembraneDevice, MembraneError, MembraneSpec, SpeciesTemplate, device as tdev,
)
from molar_tpu_torch.tasks.trajectory import TrajectoryReader

from test_membrane_device import TOML, make_bilayer
from torch_scenes import membrane_diffs, membrane_within_bars

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))

import workloads as ref_wl  # noqa: E402

TWO_SPECIES = """
sel = "all"
cutoff = 2.0
order_type = "scdcorr"
output_dir = "{out}"
groups = ["all"]

[lipids.LIQ]
whole = "resname LIQ"
head = "name P"
mid = "name G"
tails = ["C1-C2=C3-C4"]

[lipids.LIP]
whole = "resname LIP"
head = "name P"
mid = "name G"
tails = ["C1-C2-C3-C4"]
"""

# name -> (TOML text with {out}, make_bilayer kwargs, frames, host comparison)
SCENES = {
    "bend": (TOML.format(out="{out}", extra=""), {}, 4, True),
    "triclinic": (TOML.format(out="{out}", extra=""), {"tilt": 0.9}, 4, True),
    "smooth2": (TOML.format(out="{out}", extra="max_smooth_iter = 2"), {}, 4, True),
    "shells1": (TOML.format(out="{out}", extra="n_shells_smoothing = 1"), {}, 4, True),
    "shells2_sz": (TOML.format(out="{out}", extra="n_shells_smoothing = 2")
                   .replace('"scdcorr"', '"sz"'), {}, 3, False),
    "global_normal_scd": (TOML.format(out="{out}", extra="global_normal = [0.0, 0.0, 1.0]")
                          .replace('"scdcorr"', '"scd"'), {}, 3, False),
    "double_bond": (TOML.format(out="{out}", extra="").replace("C1-C2-C3-C4", "C1-C2=C3-C4"),
                    {}, 3, False),
    "two_species": (TWO_SPECIES, {"species": True}, 3, False),
    "clamp": (TOML.format(out="{out}", extra=""), {"nx": 2, "ny": 2}, 1, False),
    "small_cap": (TOML.format(out="{out}", extra=""), {"cap": 8}, 2, False),
}


NO_OUTPUT = "/nonexistent"  # the scenes write no statistics files


def _system(species=False, **kw):
    system = make_bilayer(**kw)
    if species:  # every other lipid becomes LIQ
        top = system.topology
        names = top.resnames()
        names = np.where(top.resindex % 2 == 1, "LIQ", names)
        top.resname = top.resname_pool.intern_all(list(names))
    return system


def _host_frame(memb):
    lips = memb.lipids
    return {
        "valid": np.array([l.valid for l in lips]),
        "area": np.array([l.area for l in lips]),
        "mean": np.array([l.mean_curv for l in lips]),
        "gauss": np.array([l.gaussian_curv for l in lips]),
        "nneib": np.array([len(l.neib_ids) for l in lips]),
        "neib": [sorted(l.neib_ids) for l in lips],
        "order": [np.array(l.order[0]) for l in lips],
    }


@functools.cache
def scene(name):
    """Everything a scene's tests read, built once: the reference device,
    the port's, the window, both outputs and (where asked) the host run."""
    toml, kw, n_frames, host = SCENES[name]
    kw = dict(kw)
    cap = kw.pop("cap", None)
    species = kw.pop("species", False)
    system = _system(species, **kw)
    memb = Membrane(system, toml.format(out=NO_OUTPUT))
    memb.add_ids_to_group("all", range(len(memb.lipids)))
    ref = RefDevice(memb, patch_cap=cap)
    spec, ref_cap = convert.membrane_from_reference(ref)
    port = MembraneDevice(spec, system.state.coords, system.state.box.matrix, patch_cap=cap,
                          device="cpu")
    rng = np.random.default_rng(3)
    base = system.state.coords.copy()
    frames = [base + rng.normal(0, 0.01, base.shape).astype(np.float32)
              for _ in range(n_frames)]
    window = np.stack([c[ref.subset] for c in frames]).astype(np.float32)
    out = {"ref": ref, "port": port, "ref_cap": ref_cap, "window": window,
           "want": ref.compute_window(window), "got": port.compute_window(window)}
    if host:
        system = _system(species, **kw)  # the host run moves its own system
        hm = Membrane(system, toml.format(out=NO_OUTPUT))
        hm.add_ids_to_group("all", range(len(hm.lipids)))
        out["host"] = []
        for c in frames:
            system.state.coords = c.copy()
            hm.compute()
            out["host"].append(_host_frame(hm))
        out["host_membrane"] = hm
    if name == "triclinic":  # per-frame (NPT-like) boxes through the same objects
        base_box = np.asarray(system.state.box.matrix, np.float64)
        boxes = np.stack([base_box * (1.0 + 0.01 * k) for k in range(n_frames)])
        npt = np.stack([(c * (1.0 + 0.01 * k))[ref.subset]
                        for k, c in enumerate(frames)]).astype(np.float32)
        out["npt"] = (ref.compute_window(npt, boxes=boxes), port.compute_window(npt, boxes=boxes))
        out["host_npt"] = []
        for k, c in enumerate(frames):
            system.state.coords = (c * (1.0 + 0.01 * k)).astype(np.float32)
            system.state.box = RefBox(boxes[k].astype(np.float32))
            hm.compute()
            out["host_npt"].append(_host_frame(hm))
    return out


def _assert_outputs_match(want, got, sp_lipids):
    """Flags, counts and neighbour sets equal; floats within
    ``torch_scenes.MEMBRANE_BARS``. A lipid that is not valid (a failed or
    runaway fit, a Voronoi wall) keeps whatever its ill-conditioned fit
    gave: its area, curvatures, normal and order are read by nothing and
    are compared only where valid."""
    diffs = membrane_diffs(want, got, sp_lipids)
    assert membrane_within_bars(diffs), diffs


@pytest.mark.parametrize("name", sorted(SCENES))
def test_port_matches_the_jax_device_path(name):
    s = scene(name)
    assert s["port"].patch_cap == s["ref_cap"] == s["ref"].patch_cap
    assert s["port"]._triclinic == (name == "triclinic")
    if name == "small_cap":
        np.testing.assert_array_equal(s["got"]["overflow"], s["want"]["overflow"])
        assert s["got"]["overflow"].all()
        return
    assert not s["got"]["overflow"].any()
    # (the 8-lipid clamp scene is all walls: no lipid is valid in either package)
    assert s["got"]["valid"].any() == (name != "clamp")
    _assert_outputs_match(s["want"], s["got"], s["port"]._sp_lipids)


def test_per_frame_boxes_match_the_jax_device_path():
    s = scene("triclinic")
    _assert_outputs_match(*s["npt"], s["port"]._sp_lipids)


def _assert_host_bars(outs, host, order_of=None):
    """``test_membrane_device.py``'s bars for the device path vs the host."""
    for fr, h in enumerate(host):
        np.testing.assert_array_equal(outs["valid"][fr], h["valid"], err_msg=f"valid {fr}")
        v = h["valid"]
        np.testing.assert_allclose(outs["area"][fr][v], h["area"][v], rtol=2e-3)
        np.testing.assert_allclose(outs["mean_curv"][fr][v], h["mean"][v], rtol=0.05, atol=5e-4)
        np.testing.assert_allclose(outs["gauss_curv"][fr][v], h["gauss"][v], rtol=0.05,
                                   atol=5e-4)
        np.testing.assert_array_equal(outs["n_neighbors"][fr][v], h["nneib"][v])
        for i in np.nonzero(v)[0]:
            assert sorted(outs["nb_ids"][fr][i][outs["nb_mask"][fr][i]]) == h["neib"][i]
        if order_of is not None:
            for r, lid in enumerate(order_of):
                if v[lid]:
                    np.testing.assert_allclose(outs["order"]["LIP"][0][fr][r], h["order"][lid],
                                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", sorted(n for n, s in SCENES.items() if s[3]))
def test_port_matches_the_host_pipeline(name):
    s = scene(name)
    _assert_host_bars(s["got"], s["host"], s["port"]._sp_lipids["LIP"])


def test_per_frame_boxes_match_the_host_pipeline():
    s = scene("triclinic")
    _assert_host_bars(s["npt"][1], s["host_npt"])


@pytest.mark.parametrize("name", ["bend", "two_species", "triclinic"])
def test_group_statistics_match_the_reference(name, tmp_path):
    s = scene(name)
    s["ref"].accumulate(s["want"])  # the one test that folds into the reference's groups
    ref_memb = s["ref"].membrane
    spec, _ = convert.membrane_from_reference(s["ref"])
    port = MembraneDevice(spec, s["ref"].membrane.system.state.coords,
                          s["ref"].membrane.system.state.box.matrix, device="cpu")
    port.accumulate(s["got"])
    for gname, gr in ref_memb.groups.items():
        mine = port.groups[gname]
        assert mine.species_names == gr.species_names and mine.lipid_ids == gr.lipid_ids
        for sp in gr.species_names:
            st, my = gr.per_species[sp], mine.per_species[sp]
            for key in ("count", "area", "tilt", "mean_curv", "gauss_curv", "n_neighbors"):
                assert my[key].n == st[key].n
                np.testing.assert_allclose(my[key].mean, st[key].mean, rtol=1e-4, atol=1e-6)
                np.testing.assert_allclose(my[key].m2, st[key].m2, rtol=1e-3, atol=1e-9)
            for other, acc in st["neib_fractions"].items():
                assert my["neib_fractions"][other].n == acc.n
                np.testing.assert_allclose(my["neib_fractions"][other].mean, acc.mean, atol=1e-12)
            for a, b in zip(my["order"], st["order"]):
                np.testing.assert_allclose(a.mean, b.mean, rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(a.m2, b.m2, rtol=1e-3, atol=1e-9)
        gr.save(str(tmp_path / "ref"))
        mine.save(str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names and names == sorted(os.listdir(tmp_path / "port"))
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f


def test_group_statistics_match_the_host_pipeline():
    s = scene("bend")
    spec, _ = convert.membrane_from_reference(s["ref"])
    port = MembraneDevice(spec, s["ref"].membrane.system.state.coords,
                          s["ref"].membrane.system.state.box.matrix, device="cpu")
    port.accumulate(s["got"])
    for gname, gh in s["host_membrane"].groups.items():
        for sp in gh.species_names:
            sth, my = gh.per_species[sp], port.groups[gname].per_species[sp]
            for key in ("count", "area", "tilt", "mean_curv", "gauss_curv", "n_neighbors"):
                np.testing.assert_allclose(my[key].mean, sth[key].mean, rtol=0.05, atol=2e-3)
            for other, acc in sth["neib_fractions"].items():
                np.testing.assert_allclose(my["neib_fractions"][other].mean, acc.mean, atol=1e-6)
            for a, b in zip(my["order"], sth["order"]):
                np.testing.assert_allclose(a.mean, b.mean, rtol=1e-3, atol=1e-4)


def test_overflow_matches_and_accumulate_raises():
    s = scene("small_cap")
    with pytest.raises(Exception, match="patch capacity"):
        s["ref"].accumulate(s["want"])
    with pytest.raises(MembraneError, match="patch capacity"):
        s["port"].accumulate(s["got"])


def test_n_shells_patch_raises():
    spec, _ = convert.membrane_from_reference(scene("bend")["ref"])
    spec = dataclasses.replace(spec, options=dataclasses.replace(spec.options, n_shells_patch=1))
    with pytest.raises(MembraneError, match="n_shells_patch"):
        MembraneDevice(spec, scene("bend")["ref"].membrane.system.state.coords,
                       np.diag([4.0, 4.0, 6.0]), device="cpu")


def test_tilted_frame_box_on_an_orthorhombic_build_raises():
    s = scene("bend")
    tri = np.asarray(s["ref"].membrane.system.state.box.matrix, np.float64).copy()
    tri[0, 2] = 1.0
    with pytest.raises(MembraneError, match="orthorhombic"):
        s["port"].compute_window(s["window"][:1], boxes=tri[None])


def test_unknown_engine_raises():
    spec, _ = convert.membrane_from_reference(scene("bend")["ref"])
    with pytest.raises(MembraneError):
        MembraneDevice(spec, scene("bend")["ref"].membrane.system.state.coords,
                       np.diag([4.0, 4.0, 6.0]), engine="fastest")


@pytest.mark.parametrize("name", ["bend", "double_bond", "two_species", "clamp"])
def test_spec_from_templates_equals_the_reference(name):
    """``MembraneSpec.from_templates`` derives what the reference derives
    from its ``Membrane`` (lipid order: the options' species order, then
    residues)."""
    s = scene(name)
    want, _ = convert.membrane_from_reference(s["ref"])
    memb = s["ref"].membrane
    sp_tails = {"C1-C2-C3-C4": (1, 1, 1), "C1-C2=C3-C4": (1, 2, 1)}
    templates = {
        sp.name: SpeciesTemplate(head=(0,), mid=(1,), tails=tuple(
            ((2, 3, 4, 5), sp_tails[t]) for t in memb.options.lipids[sp.name]["tails"]))
        for sp in memb.species}
    lipids = [(l.species.name, int(l.sel.indices[0]), len(l.sel.indices)) for l in memb.lipids]
    got = MembraneSpec.from_templates(templates, lipids, memb.system.topology.mass,
                                      memb.system.state.box.matrix, want.options,
                                      groups=want.groups)
    for field in ("subset", "first", "atom_first", "masses", "species_of"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    for field in ("head", "mid", "tail"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.species_names == want.species_names and got.triclinic == want.triclinic
    for sp in want.species_names:
        np.testing.assert_array_equal(got.sp_lipids[sp], want.sp_lipids[sp])
        assert [o for _, o in got.sp_tails[sp]] == [o for _, o in want.sp_tails[sp]]
        for (a, _), (b, _) in zip(got.sp_tails[sp], want.sp_tails[sp]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- blocks


def test_solve6_cholesky_matches_with_a_non_positive_definite_row():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(7, 6, 6)).astype(np.float32)
    M = np.einsum("bij,bkj->bik", a, a) + 0.1 * np.eye(6, dtype=np.float32)
    M[3] = -np.eye(6, dtype=np.float32)  # not positive definite
    M[5, 2, 2] = np.inf
    rhs = rng.normal(size=(7, 6)).astype(np.float32)
    want, want_ok = jdev._solve6_cholesky(jnp.asarray(M), jnp.asarray(rhs))
    got, ok = tdev._solve6_cholesky(torch.from_numpy(M), torch.from_numpy(rhs))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert not ok[3] and not ok[5] and ok[0]
    np.testing.assert_allclose(got.numpy()[ok.numpy()], np.asarray(want)[ok.numpy()],
                               rtol=1e-5, atol=1e-6)


def test_voronoi_planes_match():
    rng = np.random.default_rng(6)
    L, K = 40, 12
    pts = rng.uniform(-1.5, 1.5, (L, K, 2)).astype(np.float32)
    pmask = rng.uniform(size=(L, K)) < 0.8
    pmask[3] = False  # an empty patch: the box walls own the cell
    pts[5, 0] = 0.0  # a target at the origin: an inactive plane
    want = jax.jit(jdev._voronoi_planes)(jnp.asarray(pts), jnp.asarray(pmask))
    got = tdev._voronoi_planes(torch.from_numpy(pts), torch.from_numpy(pmask))
    for label, w, g in zip(("has_edge", "wall", "e1", "e2", "edge_ok"), want, got):
        w, g = np.asarray(w), g.numpy()
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=label)
        else:
            ok = np.asarray(want[4])[..., None]
            np.testing.assert_allclose(np.where(ok, g, 0), np.where(ok, w, 0), rtol=1e-5,
                                       atol=1e-6, err_msg=label)
    assert np.asarray(want[1])[3]


@pytest.mark.parametrize("order_type", ["sz", "scd", "scdcorr"])
@pytest.mark.parametrize("orders", [(1, 1, 1, 1), (1, 2, 1, 1), (2, 1, 1, 1)])
def test_order_batch_matches(order_type, orders):
    rng = np.random.default_rng(7)
    steps = rng.normal(0, 0.08, (30, 5, 3)) + np.array([0.0, 0.0, -0.13])
    coords = np.cumsum(steps, axis=1).astype(np.float32)
    normals = rng.normal(size=(30, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    want = jdev._order_batch(order_type, jnp.asarray(coords), jnp.asarray(normals), orders)
    got = tdev._order_batch(order_type, torch.from_numpy(coords), torch.from_numpy(normals),
                            orders)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)


def test_min_image_tric_and_corrections_match():
    rng = np.random.default_rng(8)
    mat = np.array([[4.0, 0.9, 1.1], [0.0, 4.0, 0.7], [0.0, 0.0, 6.0]], np.float32)
    inv = np.linalg.inv(mat.astype(np.float64)).astype(np.float32)
    vec = rng.uniform(-8, 8, (500, 3)).astype(np.float32)
    vec[:3] = 0.5 * (mat[:, 0] + mat[:, 1])  # a tie between two images
    corr = jdev._frame_corrections(jnp.asarray(mat))
    tcorr = tdev._frame_corrections(torch.from_numpy(mat))
    np.testing.assert_array_equal(tcorr.numpy(), np.asarray(corr))
    want = jdev._min_image_tric(jnp.asarray(vec), jnp.asarray(mat), jnp.asarray(inv), corr)
    got = tdev._min_image_tric(torch.from_numpy(vec), torch.from_numpy(mat),
                               torch.from_numpy(inv), tcorr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ext = np.array([4.0, 5.0, 6.0], np.float32)
    np.testing.assert_array_equal(
        tdev._min_image_ortho(torch.from_numpy(vec), torch.from_numpy(ext)).numpy(),
        np.asarray(jdev._min_image_ortho(jnp.asarray(vec), jnp.asarray(ext))))


def test_periodic_box_shortest_vector_matches_the_reference():
    from molar_tpu_torch.core.pbc import PeriodicBox

    rng = np.random.default_rng(9)
    vec = rng.normal(0, 5, (300, 3))
    for m in (np.diag([4.0, 5.0, 6.0]), [[4.0, 0.9, 1.1], [0.0, 4.0, 0.7], [0.0, 0.0, 6.0]]):
        np.testing.assert_array_equal(PeriodicBox(m).shortest_vector(vec),
                                      RefBox(np.asarray(m, np.float32)).shortest_vector(vec))


# ---------------------------------------------------------------- workload


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The membrane workload at 50 lipids, 8 frames, windows of 4: the
    reference's device row on JAX-CPU, the port's stream on the CPU."""
    d = tmp_path_factory.mktemp("membrane")
    n_frames = 8
    ref_n, ref_s, ref_checks = ref_wl.wl_membrane(n_frames=n_frames, device=True, window=4,
                                                  nx=5, ny=5, stash_key="port_test")
    ref_dev, ref_frames = ref_wl._MEMBRANE_RUNS.pop("port_test")
    bilayer = wl.synth_bilayer(5, 5)
    xtc = str(d / "membrane.xtc")
    wl.write_membrane_xtc(bilayer, xtc, n_frames)
    got = wl.run("membrane", bilayer, xtc, 4, "cpu")
    (decoded, _, _, _, _), = TrajectoryReader([xtc]).iter_windows(n_frames)
    return d, bilayer, ref_dev, ref_frames, ref_checks, got, decoded


def test_synth_bilayer_equals_the_reference(workload):
    _, bilayer, ref_dev, ref_frames, _, _, _ = workload
    np.testing.assert_array_equal(bilayer.frames(len(ref_frames)), np.stack(ref_frames))
    np.testing.assert_array_equal(bilayer.box, ref_dev.membrane.system.state.box.matrix)
    want, cap = convert.membrane_from_reference(ref_dev)
    for field in ("subset", "first", "atom_first", "masses", "species_of"):
        np.testing.assert_array_equal(getattr(bilayer.spec, field), getattr(want, field))
    for field in ("head", "mid", "tail"):
        for a, b in zip(getattr(bilayer.spec, field), getattr(want, field)):
            np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(bilayer.spec.options) | {"output_dir": "."} == \
        dataclasses.asdict(want.options) | {"output_dir": "."}
    assert bilayer.spec.groups == want.groups
    port = MembraneDevice(bilayer.spec, bilayer.coords, bilayer.box, device="cpu")
    assert port.patch_cap == cap


def test_membrane_workload_checks_match_the_reference(workload):
    """The port's module on the reference's own frames gives its check
    scalars within 1e-5; the streamed (XTC-quantized) run within
    ``MEMBRANE_TOL``."""
    _, bilayer, ref_dev, ref_frames, ref_checks, got, _ = workload
    port = MembraneDevice(bilayer.spec, bilayer.coords, bilayer.box, device="cpu")
    outs = [port.compute_window(np.stack([c[port.subset] for c in ref_frames[s:s + 4]]))
            for s in range(0, len(ref_frames), 4)]
    mine = wl._checks("membrane", outs, bilayer.spec)
    for k, v in ref_checks.items():
        assert abs(mine[k] - v) <= 1e-5 * abs(v) + 1e-7, (k, mine[k], v)
    frames, _, checks = got
    assert frames == len(ref_frames)
    assert not wl.membrane_mismatches(checks, ref_checks)


def test_membrane_sidecar_is_byte_equal_and_native_agrees(workload):
    d, bilayer, ref_dev, _, _, got, decoded = workload
    mine, theirs = str(d / "port.bin"), str(d / "ref.bin")
    wl.write_membrane_native(bilayer.spec, bilayer.box, decoded, mine)
    ref_wl._write_membrane_native(ref_dev, list(decoded), theirs)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    native = wl.run_native_membrane(bilayer.spec, bilayer.box, decoded, str(d))
    assert native["frames"] == len(decoded)
    assert not wl.membrane_mismatches(got[2], native), (got[2], native)


def test_membrane_checks_raise_without_a_valid_lipid(workload):
    _, bilayer, _, _, _, _, _ = workload
    L = bilayer.spec.n_lipids
    outs = [{"valid": np.zeros((2, L), bool), "area": np.ones((2, L)),
             "mean_curv": np.zeros((2, L)), "order": {"LIP": [np.zeros((2, L, 2))]}}]
    with pytest.raises(RuntimeError, match="ZERO valid lipids"):
        wl._checks("membrane", outs, bilayer.spec)
