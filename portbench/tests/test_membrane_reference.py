"""The membrane reference (``reference/membrane.py``) on cases whose answers
are known in closed form, the seeded POPC bilayer it is run on
(``harness/bilayer.py``), the work count of its roofline, and the readers of
the program's membrane spans."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench.drivers.common import LayerRun
from portbench.harness import bilayer, membrane_work, spec
from portbench.reference import membrane as ref

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _two_atom_lipids(heads: np.ndarray, up: np.ndarray) -> tuple:
    """Lipids of a head and a tail end 1.5 nm below it along ``up`` ->
    (coords, Lipids)."""
    tails = heads - 1.5 * up
    coords = np.stack([heads, tails], axis=1).reshape(-1, 3)
    lipids = ref.Lipids(rows=torch.arange(len(coords)).reshape(-1, 2),
                        masses=torch.tensor([31.0, 12.0], dtype=F64), head=[0], tail_end=[1],
                        tails=[])
    return torch.as_tensor(coords, dtype=F64), lipids


def _hexagonal_sheet(a: float, nx: int = 12, ny: int = 14):
    """A flat periodic hexagonal lattice of spacing ``a`` -> (heads, the
    reference's analysis of it, the box's sides)."""
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    x = (i + 0.5 * (j % 2)) * a
    y = j * a * math.sqrt(3) / 2
    heads = np.stack([x.ravel(), y.ravel(), np.full(x.size, 4.0)], axis=1)
    coords, lipids = _two_atom_lipids(heads, np.array([0.0, 0.0, 1.0]))
    sides = torch.tensor([nx * a, ny * a * math.sqrt(3) / 2, 8.0], dtype=F64)
    return heads, ref.analyse(coords, sides, lipids, cutoff=2.5), sides.numpy()


def test_a_hexagonal_lattice_gives_each_cell_its_area():
    """Every cell of a flat hexagonal lattice is the regular hexagon of
    area sqrt(3)/2 a^2, no curvature."""
    a = 0.8
    _, r, _ = _hexagonal_sheet(a)
    assert r["valid"].all()
    np.testing.assert_allclose(r["area"].numpy(), math.sqrt(3) / 2 * a * a, rtol=1e-12)
    np.testing.assert_allclose(r["mean_curv"].numpy(), 0.0, atol=1e-12)


def test_a_hexagonal_lattice_gives_each_cell_its_six_nearest_neighbours():
    """The Voronoi neighbours of a hexagonal lattice's cell are the six
    lattice points at one spacing, under the minimum image."""
    a = 0.8
    heads, r, sides = _hexagonal_sheet(a)
    assert (r["n_neighbors"] == 6).all()
    ids = r["nb_ids"].numpy()
    assert ((ids >= 0).sum(1) == 6).all()
    rows, cols = np.nonzero(ids >= 0)
    d = heads[ids[rows, cols]] - heads[rows]
    d -= sides * np.round(d / sides)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), a, rtol=1e-12)


def test_a_spherical_cap_gives_mean_curvature_one_over_r():
    """Heads on a sphere of radius R (normals outward): the lipid at the
    pole fits the quadric of the sphere, mean curvature 1/R and Gaussian
    1/R^2 (the quartic term r^4 / 8R^3 that a quadric leaves out moves
    them by under 0.2 % at R = 40 nm and a 2.5 nm patch)."""
    R, a = 40.0, 0.8
    i, j = np.meshgrid(np.arange(-6, 7), np.arange(-7, 8), indexing="ij")
    x = ((i + 0.5 * (j % 2)) * a).ravel()
    y = (j * a * math.sqrt(3) / 2).ravel()
    centre = np.array([50.0, 50.0, 10.0])
    up = np.stack([x, y, np.sqrt(R * R - x * x - y * y)], axis=1) / R
    heads = centre + R * up
    coords, lipids = _two_atom_lipids(heads, up)
    sides = torch.tensor([100.0, 100.0, 100.0], dtype=F64)
    r = ref.analyse(coords, sides, lipids, cutoff=2.5)
    pole = int(np.argmin(x * x + y * y))
    assert bool(r["valid"][pole])
    assert float(r["mean_curv"][pole]) == pytest.approx(1 / R, rel=2e-3)
    assert float(r["gauss_curv"][pole]) == pytest.approx(1 / R**2, rel=4e-3)
    np.testing.assert_allclose(r["normal"][pole].numpy(), [0, 0, 1], atol=1e-4)


def _all_trans(n: int, tilt_deg: float, in_plane: bool) -> torch.Tensor:
    """An all-trans chain of ``n`` carbons zigzagging in the x-z plane
    along -z, tilted by ``tilt_deg`` within that plane (about y) or across
    it (about x) -> (1, n, 3)."""
    k = np.arange(n)
    chain = np.stack([0.0433 * (-1.0) ** k, 0 * k, -0.1261 * k], axis=1)
    t = math.radians(tilt_deg)
    c, s = math.cos(t), math.sin(t)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) if in_plane else \
        np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return torch.as_tensor(chain @ rot.T, dtype=F64)[None]


@pytest.mark.parametrize("order_type", ["scd", "scdcorr"])
@pytest.mark.parametrize("tilt,in_plane,want", [
    (0.0, True, 0.5),                      # the chain along the normal: -S_CD = 1/2
    (30.0, True, (1 - 0.5 * (3 * 0.25 - 1)) / 3),    # (1 - P2(sin t)) / 3
    (30.0, False, (0.5 - 2 * 0.5 * (3 * 0.25 - 1)) / 3),  # (1/2 - 2 P2(sin t)) / 3
])
def test_an_all_trans_chain_at_a_known_tilt(order_type, tilt, in_plane, want):
    """At a saturated carbon the hydrogens' frame is the chain axis, the
    zigzag plane's normal and the axis across it: -S_CD = -(2 Sxx + Syy)/3
    with Sii = P2 of the angle of axis i with the normal."""
    chain = _all_trans(8, tilt, in_plane)
    got = ref.tail_order(order_type, chain, torch.tensor([[0.0, 0.0, 1.0]], dtype=F64),
                         (1,) * 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_sz_of_a_chain_at_a_known_tilt():
    chain = _all_trans(6, 40.0, True)
    got = ref.tail_order("sz", chain, torch.tensor([[0.0, 0.0, 1.0]], dtype=F64), (1,) * 5)
    np.testing.assert_allclose(got.numpy(), 0.5 * (3 * math.cos(math.radians(40)) ** 2 - 1),
                               atol=1e-12)


def test_the_double_bond_correction_at_120_degrees_is_the_plain_form():
    """At bond angles of exactly 120 degrees the corrected double-bond form
    (the half supplement of the angle, 30 degrees) is the fixed form."""
    rng = np.random.default_rng(3)
    ang = math.radians(120.0)
    c = [np.zeros(3), np.array([0.153, 0, 0])]
    c.append(c[1] + 0.134 * np.array([math.cos(math.pi - ang), math.sin(math.pi - ang), 0]))
    d = c[2] - c[1]
    rot = np.array([[math.cos(-ang), -math.sin(-ang), 0], [math.sin(-ang), math.cos(-ang), 0],
                    [0, 0, 1]])
    c.append(c[2] + 0.153 * (rot @ (-d / np.linalg.norm(d))))
    c.append(c[3] + np.array([0.1, 0.1, 0.05]))
    chain = torch.as_tensor(np.stack(c), dtype=F64)[None]
    normal = torch.as_tensor(rng.normal(size=(1, 3)), dtype=F64)
    bonds = (1, 2, 1, 1)
    corr = ref.tail_order("scdcorr", chain, normal, bonds)
    plain = ref.tail_order("scd", chain, normal, bonds)
    np.testing.assert_allclose(corr[:, :2].numpy(), plain[:, :2].numpy(), atol=1e-12)


def test_the_seeded_bilayer():
    """134 CHARMM36 names a POPC, the tails' strings, no two atoms of a
    lipid closer than a bond, the leaflets apart, the area a lipid."""
    cfg = spec.tiny_config("charmm36_popc_4608")
    s = bilayer.build(cfg)
    n = cfg["composition"]["POPC"]
    assert len(s["coords"]) == cfg["atoms"] == n * 134
    names = bilayer.NAMES
    assert names.count("P") == 1 and "C29" in names and "C316" in names and "C218" in names
    assert cfg["analysis"]["tails"] == [bilayer.SN1_TAIL, bilayer.SN2_TAIL]
    assert "C29=C210" in bilayer.SN2_TAIL and "=" not in bilayer.SN1_TAIL
    x = s["coords"].reshape(n, 134, 3).astype(np.float64)
    d = np.linalg.norm(x[:, :, None] - x[:, None], axis=-1)
    d[:, np.arange(134), np.arange(134)] = np.inf
    assert d.min() >= bilayer.MIN_APART_NM
    z = x[:, names.index("P"), 2]
    assert (z[s["leaflet"] > 0].min() - z[s["leaflet"] < 0].max()) > 2.5
    box = np.diag(s["box"]).astype(np.float64)
    assert box[0] * box[1] / (n // 2) == pytest.approx(cfg["bilayer"]["area_per_lipid_nm2"],
                                                       rel=1e-3)
    # The same seed, the same bilayer.
    np.testing.assert_array_equal(bilayer.build(cfg)["coords"], s["coords"])


def test_the_work_count_of_a_window():
    """Two frames of a hexagonal sheet: every lipid's patch (the lattice
    points within 2.5 nm, 36 of them at spacing 0.8: shells at 1, sqrt(3),
    2, sqrt(7) and 3 spacings), the bytes of the atoms the analysis reads
    and of the results written."""
    a, nx, ny = 0.8, 12, 14
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    heads = np.stack([((i + 0.5 * (j % 2)) * a).ravel(), (j * a * math.sqrt(3) / 2).ravel(),
                      np.full(i.size, 4.0)], axis=1)
    sides = torch.tensor([nx * a, ny * a * math.sqrt(3) / 2, 8.0], dtype=F64)
    w = membrane_work.window_work(torch.as_tensor(np.stack([heads, heads])), sides, 2.5,
                                  read_atoms=3, order_values=2)
    n = len(heads)
    assert w["items"] == 2 * n * 36
    assert w["bytes"] == (2 * 72 + 2 * n * (3 * 6 + 41 + 4 * 2) + 5 * w["items"])
    assert w["flops"] > membrane_work.FLOPS_PER_PATCH_SLOT * w["items"]


def _run(spans):
    return LayerRun(frames=64, window_s=2.0, spans=spans)


@pytest.mark.parametrize("metric,spans,want", [
    ("membrane_patches_ms_per_frame", {"membrane.patches@device": 0.128,
                                       "membrane.patches": 9.0}, 2.0),
    ("membrane_voronoi_ms_per_frame", {"membrane.smooth.voronoi@device": 0.64}, 10.0),
    ("membrane_fold_ms_per_frame", {"membrane.fold": 0.032}, 0.5),
])
def test_the_membrane_span_readers(metric, spans, want):
    assert spec.reader(metric).read(_run(spans)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["membrane_patches_ms_per_frame",
                                    "membrane_voronoi_ms_per_frame",
                                    "membrane_fold_ms_per_frame", "membrane_roofline_pct"])
def test_a_run_without_the_membrane_spans_reads_nothing(metric):
    """The parent of the change that adds the spans has none of them."""
    assert spec.reader(metric).read(_run({"patches": 1.0, "smooth.voronoi": 1.0})) is None
