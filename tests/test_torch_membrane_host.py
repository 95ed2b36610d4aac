"""The port's host membrane pipeline (``membrane/membrane.py``,
``ops/voronoi.py``, ``membrane/vmd_visual.py``) against the JAX package's,
on the CPU.

Each scene is a flat bilayer of ``tests/test_membrane.py``'s
``make_bilayer`` (the same columns in both packages) with that file's TOML
and one option changed; three frames of seeded noise go through
``Membrane.compute`` in both packages, leaflets split as the ``membrane``
command splits them. Per frame, every lipid's flag and neighbour ids are
equal and its area, curvatures, normal, markers and order within 1e-6
relative (atol 1e-9); the group statistics within 1e-6 relative and the
group files byte-equal. ``merge_stats_from``, the VMD file, ``Histogram1D``,
the 2D Voronoi cell, the quadric fit and the group API's errors equal the
reference's. ``MembraneDevice(membrane)`` on the CPU folds into the
membrane's own groups and agrees with the host pipeline within
``workloads.MEMBRANE_TOL`` (the device pipeline's marker smoothing is a
gather where the host scatters).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from molar_tpu.membrane import Membrane as RefMembrane
from molar_tpu.membrane import membrane as ref_membrane
from molar_tpu.membrane.vmd_visual import Histogram1D as RefHistogram
from molar_tpu.ops import voronoi as ref_voronoi

from molar_tpu_torch.membrane import (
    LipidGroup, Membrane, MembraneDevice, MembraneError, MembraneSpec, get_quad_coefs,
    split_leaflets,
)
from molar_tpu_torch.membrane.stats import _RunningStats
from molar_tpu_torch.membrane.vmd_visual import Histogram1D, VmdVisual
from molar_tpu_torch.ops import voronoi

from test_membrane import TOML, make_bilayer
from test_torch_membrane_toml import port_system
from torch_scenes import membrane_group_diffs

RTOL, ATOL = 1e-6, 1e-9
N_FRAMES = 3

# name -> (TOML change, make_bilayer size)
SCENES = {
    "flat": ("", 6),
    "smooth2": ("max_smooth_iter = 2", 6),
    "shells_patch": ("n_shells_patch = 2", 5),
    "shells_smoothing": ("n_shells_smoothing = 2", 5),
    "sz": ('order_type = "sz"', 5),
    "global_normal_scd": ('order_type = "scd"\nglobal_normal = [0.0, 0.0, 1.0]', 5),
    "double_bond": ("", 5),
    "one_group": ("", 5),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toml_of(scene, out):
    change, _ = SCENES[scene]
    text = TOML.format(out=out).replace('order_type = "scdcorr"\n', "")
    text = text.replace("max_smooth_iter = 1\n", "")
    if scene == "double_bond":
        text = text.replace("C1-C2-C3-C4", "C1-C2=C3-C4")
    if scene == "one_group":
        text = text.replace('groups = ["upper", "lower"]\n', "")
    head, lipids = text.split("[lipids.LIP]")
    return head + change + ("\n" if change else "") + "[lipids.LIP]" + lipids


def reference_split(m, system):
    """The JAX ``membrane`` command's split (molar_tpu/cli.py:256-266), on
    the JAX package's ``Membrane``; the port's is ``split_leaflets``."""
    for lip in m.lipids:
        lip.update_markers(system)
    if "upper" in m.groups and "lower" in m.groups:
        z0 = float(np.median([l.head_marker[2] for l in m.lipids]))
        m.add_ids_to_group("upper", [l.id for l in m.lipids if l.head_marker[2] > z0])
        m.add_ids_to_group("lower", [l.id for l in m.lipids if l.head_marker[2] <= z0])


def frames_of(ref_system, seed=0, n=N_FRAMES):
    rng = np.random.default_rng(seed)
    c = ref_system.state.coords
    return [(c + rng.normal(0, 0.02, c.shape)).astype(np.float32) for _ in range(n)]


def both(scene, tmp_path, frames=None):
    """Both packages' membranes of ``scene`` over its frames; yields after
    each frame so a test can compare the lipids."""
    ref_sys = make_bilayer(SCENES[scene][1], SCENES[scene][1])
    mine_sys = port_system(ref_sys)
    frames = frames_of(ref_sys) if frames is None else frames
    ref = RefMembrane(ref_sys, toml_of(scene, tmp_path / "ref"))
    mine = Membrane(mine_sys, toml_of(scene, tmp_path / "mine"))
    reference_split(ref, ref_sys)
    split_leaflets(mine)
    for c in frames:
        ref_sys.state.coords = c.copy()
        mine_sys.state.coords = c.copy()
        ref.compute()
        mine.compute()
        yield ref, mine


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def same_lipids(ref, mine):
    assert len(ref.lipids) == len(mine.lipids)
    for a, b in zip(ref.lipids, mine.lipids):
        assert b.valid == a.valid and b.patch_ids == a.patch_ids, a.id
        assert sorted(b.neib_ids) == sorted(a.neib_ids), a.id
        close(b.head_marker, a.head_marker, "head")
        close(b.tail_head_vec, a.tail_head_vec, "thv")
        if not a.valid:
            continue
        for key in ("area", "mean_curv", "gaussian_curv", "normal", "princ_curvs"):
            close(getattr(b, key), getattr(a, key), key)
        for x, y in zip(b.order, a.order):
            close(x, y, "order")


def same_groups(ref, mine):
    assert set(ref.groups) == set(mine.groups)
    for name, gr in ref.groups.items():
        mg = mine.groups[name]
        assert mg.lipid_ids == gr.lipid_ids and mg.species_names == gr.species_names
        for sp in gr.species_names:
            a, b = gr.per_species[sp], mg.per_species[sp]
            for key in ("count", "area", "tilt", "mean_curv", "gauss_curv", "n_neighbors"):
                assert b[key].n == a[key].n, key
                close(b[key].mean, a[key].mean, key)
                close(b[key].std, a[key].std, key)
            for s, acc in a["neib_fractions"].items():
                close(b["neib_fractions"][s].mean, acc.mean, "neib_fractions")
            assert (a["order"] is None) == (b["order"] is None)
            for x, y in zip(b["order"] or [], a["order"] or []):
                close(x.mean, y.mean, "order")
                close(x.std, y.std, "order std")


def same_files(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and names
    for f in names:
        with open(os.path.join(a_dir, f), "rb") as x, open(os.path.join(b_dir, f), "rb") as y:
            assert x.read() == y.read(), f


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_host_membrane_equals_the_reference(scene, tmp_path):
    for ref, mine in both(scene, tmp_path):
        same_lipids(ref, mine)
    assert sum(l.valid for l in mine.lipids) > len(mine.lipids) // 2
    same_groups(ref, mine)
    ref.finalize()
    mine.finalize()
    same_files(tmp_path / "ref", tmp_path / "mine")


def test_vmd_file_is_byte_equal(tmp_path):
    for ref, mine in both("flat", tmp_path):
        pass
    ref.write_vmd_visualization(str(tmp_path / "ref.tcl"))
    mine.write_vmd_visualization(str(tmp_path / "mine.tcl"))
    text = (tmp_path / "mine.tcl").read_bytes()
    assert text == (tmp_path / "ref.tcl").read_bytes() and b"draw cylinder" in text
    vis = VmdVisual()
    vis.sphere(np.array([0.1, 0.2, 0.3]), 0.5, "red")
    vis.arrow(np.zeros(3), np.array([0.0, 0.0, 1.0]), "blue")
    vis.cylinder(np.zeros(3), np.ones(3), "green")
    vis.save(str(tmp_path / "a.tcl"))
    from molar_tpu.membrane.vmd_visual import VmdVisual as RefVis

    rvis = RefVis()
    rvis.sphere(np.array([0.1, 0.2, 0.3]), 0.5, "red")
    rvis.arrow(np.zeros(3), np.array([0.0, 0.0, 1.0]), "blue")
    rvis.cylinder(np.zeros(3), np.ones(3), "green")
    rvis.save(str(tmp_path / "b.tcl"))
    assert (tmp_path / "a.tcl").read_bytes() == (tmp_path / "b.tcl").read_bytes()


def test_merge_stats_from_equals_the_reference(tmp_path):
    base = make_bilayer(5, 5)
    frames = frames_of(base, seed=3, n=4)

    def run(package, frame_list, out):
        system = base if package == "ref" else port_system(base)
        cls = RefMembrane if package == "ref" else Membrane
        m = cls(system, toml_of("flat", out))
        if package == "ref":
            reference_split(m, system)
        else:
            split_leaflets(m)
        for c in frame_list:
            system.state.coords = c.copy()
            m.compute()
        return m

    shards = {p: [run(p, frames[:2], tmp_path / p), run(p, frames[2:], tmp_path / p)]
              for p in ("ref", "mine")}
    for a, b in shards.values():
        a.merge_stats_from(b)
    same_groups(shards["ref"][0], shards["mine"][0])
    whole = run("mine", frames, tmp_path / "whole")
    for name, gr in whole.groups.items():
        for sp in gr.species_names:
            for key in ("area", "mean_curv"):
                close(shards["mine"][0].groups[name].per_species[sp][key].mean,
                      gr.per_species[sp][key].mean, key)
    other = run("mine", frames[:1], tmp_path / "x")
    other.groups.pop("lower")
    with pytest.raises(MembraneError, match="group names differ"):
        shards["mine"][0].merge_stats_from(other)


def test_histogram_equals_the_reference(tmp_path):
    vals = np.random.default_rng(2).normal(0.5, 0.3, 200)
    h, r = Histogram1D(0.0, 1.0, 12), RefHistogram(0.0, 1.0, 12)
    h.add(vals)
    r.add(vals)
    np.testing.assert_array_equal(h.bins, r.bins)
    np.testing.assert_array_equal(h.centers(), r.centers())
    h.normalize_density()
    r.normalize_density()
    np.testing.assert_array_equal(h.bins, r.bins)
    h.save(str(tmp_path / "a.dat"))
    r.save(str(tmp_path / "b.dat"))
    assert (tmp_path / "a.dat").read_bytes() == (tmp_path / "b.dat").read_bytes()


def test_voronoi_and_quadric_equal_the_reference():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1.5, 1.5, (4, 9, 2))
    ids = np.tile(np.arange(9), (4, 1))
    mask = rng.uniform(size=(4, 9)) > 0.2
    got = voronoi.voronoi_cells_batch(pts, ids, mask, -10.0, 10.0, -10.0, 10.0)
    want = ref_voronoi.voronoi_cells_batch(pts, ids, mask, -10.0, 10.0, -10.0, 10.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k in range(4):
        cell, rcell = voronoi.VoronoiCell(-2, 2, -2, 2), ref_voronoi.VoronoiCell(-2, 2, -2, 2)
        for j in np.flatnonzero(mask[k]):
            cell.add_point(pts[k, j], int(j))
            rcell.add_point(pts[k, j], int(j))
        assert cell.neighbor_ids() == rcell.neighbor_ids()
        got_v, want_v = cell.vertices(), rcell.vertices()
        assert [i for _, i in got_v] == [i for _, i in want_v]
        np.testing.assert_array_equal([v for v, _ in got_v], [v for v, _ in want_v])
        assert cell.area() == rcell.area() > 0
    local = rng.normal(0, 0.5, (12, 3))
    np.testing.assert_array_equal(get_quad_coefs(local), ref_membrane.get_quad_coefs(local))
    assert get_quad_coefs(np.zeros((3, 3))) is ref_membrane.get_quad_coefs(np.zeros((3, 3)))


def test_group_api_and_errors_equal_the_reference(tmp_path):
    ref_sys = make_bilayer(3, 3)
    mine_sys = port_system(ref_sys)
    ref = RefMembrane(ref_sys, toml_of("flat", tmp_path))
    mine = Membrane(mine_sys, toml_of("flat", tmp_path))
    assert [l.id for l in mine.lipids] == [l.id for l in ref.lipids]
    assert mine.resindex_to_id == ref.resindex_to_id
    sp, rsp = mine.species[0], ref.species[0]
    np.testing.assert_array_equal(sp.head_offsets, rsp.head_offsets)
    assert [t[0].tolist() for t in sp.tails] == [t[0].tolist() for t in rsp.tails]
    for bad in (("nope", [0]), ("upper", [99])):
        with pytest.raises(Exception) as want:
            ref.add_ids_to_group(*bad)
        with pytest.raises(MembraneError) as got:
            mine.add_ids_to_group(*bad)
        assert str(got.value) == str(want.value)
    mine.add_lipids_to_group("upper", [0, 1])
    assert mine.groups["upper"].lipid_ids == [0, 1]
    mine.reset_groups()
    assert mine.groups["upper"].lipid_ids == []
    for text in (toml_of("flat", tmp_path).replace("C1-C2", "-C2"),
                 toml_of("flat", tmp_path).replace("C3-C4", "C3-"),
                 toml_of("flat", tmp_path).replace("resname LIP", "resname XXX")):
        with pytest.raises(Exception) as want:
            RefMembrane(ref_sys, text)
        with pytest.raises(MembraneError) as got:
            Membrane(mine_sys, text)
        assert str(got.value) == str(want.value)
    st = _RunningStats()
    for x in (1.0, 2.0, 4.0):
        st.add(x)
    assert isinstance(mine.groups["upper"], LipidGroup) and st.mean == pytest.approx(7 / 3)


@pytest.mark.parametrize("scene", ["flat", "double_bond", "one_group"])
def test_membrane_device_of_a_membrane_folds_into_its_groups(scene, tmp_path):
    ref_sys = make_bilayer(6, 6)
    frames = frames_of(ref_sys, seed=8)
    host_sys, dev_sys = port_system(ref_sys), port_system(ref_sys)
    host = Membrane(host_sys, toml_of(scene, tmp_path / "host"))
    dev_memb = Membrane(dev_sys, toml_of(scene, tmp_path / "dev"))
    split_leaflets(host)
    split_leaflets(dev_memb)
    for c in frames:
        host_sys.state.coords = c.copy()
        host.compute()
    dev = MembraneDevice(dev_memb, engine="cpu")
    assert dev.groups is dev_memb.groups and dev.membrane is dev_memb
    spec = MembraneSpec.from_membrane(dev_memb)
    assert spec.groups == {k: g.lipid_ids for k, g in dev_memb.groups.items()}
    np.testing.assert_array_equal(dev.subset, spec.subset)
    coords = np.stack(frames)[:, dev.subset]
    dev.accumulate(dev.compute_window(coords))
    diffs = membrane_group_diffs(host.groups, dev_memb.groups)
    assert all(v <= 1.0 for v in diffs.values()), diffs
    dev_memb.finalize()
    host.finalize()
    assert sorted(os.listdir(tmp_path / "dev")) == sorted(os.listdir(tmp_path / "host"))
    with pytest.raises(MembraneError, match="by keyword"):
        MembraneDevice(dev_memb, 16)
