"""Frames sharded over devices (``parallel/mesh.py``), port against the JAX package.

The port's mesh is a list of devices driven by one process; here every
device is the CPU (two, three or four shards), where the JAX package's
tests use its 8 virtual CPU devices. Each public name of
``molar_tpu.parallel.mesh`` is held against its counterpart: the meshes'
sizes and errors, the frame slices each device holds, ``pad_to_multiple``,
the sharded ``fit_rmsd`` window of ``tests/test_parallel.py`` (per-frame
RMSD within 1e-6 of the unsharded run and within 1e-5 of JAX's single
device, the combined frame mean within 1e-6), the runner's three wire
forms and ragged tails (the same per-frame centres as the JAX runner's on
2 and 3 devices, within 1e-6), and ``com_gyration_sharded`` on a 2 x 2 grid
(within 1e-6 relative of JAX's single device). Then the callers: the
headline stream with a forced overflow retry through a two- and a
three-shard runner (counts and checksums equal to the unsharded stream,
RMSD within 1e-6), the selection workloads through ``workloads.run(mesh=)``
(check scalars within 1e-6 relative), and the membrane's sharded shape:
two and four ``MembraneDevice`` shards merged against one pass (counts
exact, statistics within 1e-6 relative) and ``merge_stats_from`` against the JAX
``Membrane.merge_stats_from`` on the same window outputs (equal within
1e-12 relative, the same float64 Welford merge), its two errors included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from molar_tpu.membrane import Membrane
from molar_tpu.membrane import MembraneError as RefMembraneError
from molar_tpu.membrane.device import MembraneDevice as RefDevice
from molar_tpu.ops import measure as jmeasure
from molar_tpu.parallel import mesh as jmesh
from molar_tpu.tasks.trajectory import decode_window_coords as ref_decode

from molar_tpu_torch import convert, headline
from molar_tpu_torch import workloads as wl
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.membrane import MembraneDevice, MembraneError, MembraneSpec
from molar_tpu_torch.ops.measure import fit_rmsd
from molar_tpu_torch.ops.neighbor import grid_dims_for
from molar_tpu_torch.parallel import (
    MeshWindowRunner, com_gyration_sharded, frame_atom_mesh, frame_mesh, frame_sharding,
    pad_to_multiple, replicated_sharding, shard_window, sharded_window_fn,
)
from molar_tpu_torch.tasks.trajectory import TrajectoryReader, decode_window_coords

from test_membrane_device import TOML, make_bilayer

CPU = torch.device("cpu")
RMSD_ATOL = 1e-6   # sharded against unsharded
REL = 1e-6         # statistics, centres, gyration


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops; one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpus(n):
    return [CPU] * n


# ----------------------------------------------------------------- meshes


def test_frame_mesh_takes_the_first_devices_as_jax_does():
    pool = cpus(len(jax.devices()))
    for n in (None, 0, 1, 3, len(pool), len(pool) + 5):
        assert len(frame_mesh(n, devices=pool)) == jmesh.frame_mesh(n).devices.size
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in frame_mesh())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            frame_mesh()


def test_frame_atom_mesh_shape_and_error_match_jax():
    pool = cpus(len(jax.devices()))
    grid = frame_atom_mesh(4, 2, devices=pool)
    assert (len(grid), len(grid[0])) == jmesh.frame_atom_mesh(4, 2).devices.shape
    with pytest.raises(ValueError) as ref:
        jmesh.frame_atom_mesh(4, 4)
    with pytest.raises(ValueError, match=str(ref.value)):
        frame_atom_mesh(4, 4, devices=pool)


@pytest.mark.parametrize("n_dev,n_frames", [(8, 16), (4, 8), (2, 6), (1, 5)])
def test_frame_and_replicated_sharding_match_jax(n_dev, n_frames):
    jm = jmesh.frame_mesh(n_dev)
    shape = (n_frames, 10, 3)
    fmap = jmesh.frame_sharding(jm).devices_indices_map(shape)
    want = [fmap[d][0] for d in jm.devices.flat]
    got = frame_sharding(cpus(n_dev), n_frames)
    assert [(s.start, s.stop) for s in got] == [
        (w.start or 0, n_frames if w.stop is None else w.stop) for w in want]
    rmap = jmesh.replicated_sharding(jm).devices_indices_map(shape)
    assert all(rmap[d][0] == slice(None) for d in jm.devices.flat)
    a = np.arange(30.0).reshape(10, 3)
    assert all(torch.equal(t, torch.as_tensor(a)) for t in replicated_sharding(cpus(n_dev), a))
    if n_frames % n_dev == 0 and n_dev > 1:
        with pytest.raises(ValueError, match="pad"):
            frame_sharding(cpus(n_dev), n_frames + 1)


@pytest.mark.parametrize("b,multiple", [(10, 8), (8, 8), (7, 3), (1, 4), (5, 1)])
def test_pad_to_multiple_matches_jax(b, multiple):
    a = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
    t = np.arange(b, dtype=np.int16)
    (ga, gt), gvalid = pad_to_multiple((a, t), multiple)
    (wa, wt), wvalid = jmesh.pad_to_multiple((a, t), multiple)
    for g, w in ((ga, wa), (gt, wt), (gvalid, wvalid)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


# ------------------------------------------------------- sharded_window_fn


def _fit_scene():
    """The window of ``tests/test_parallel.py``'s sharded fit."""
    rng = np.random.default_rng(0)
    b, n = 16, 64
    frames = rng.uniform(0, 5, (b, n, 3)).astype(np.float32)
    boxes = np.repeat(np.diag([5.0] * 3).astype(np.float32)[None], b, 0)
    invs = np.repeat(np.diag([0.2] * 3).astype(np.float32)[None], b, 0)
    times = np.arange(b, dtype=np.float32)
    masses = rng.uniform(1, 16, n).astype(np.float32)
    return frames, boxes, invs, times, masses


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_fit_rmsd_matches_single_device(n_dev):
    frames, boxes, invs, times, masses = _fit_scene()
    ref, m = torch.as_tensor(frames[0]), torch.as_tensor(masses)

    def window_fn(coords, boxes, invs, times):
        rmsd, _, _ = fit_rmsd(coords, ref, m)
        return rmsd.mean(), rmsd

    mesh = cpus(n_dev)
    fn = sharded_window_fn(window_fn, mesh, replicated_outs=(0,), n_outs=2)
    mean_s, rmsd_s = fn(*shard_window(mesh, frames, boxes, invs, times))
    mean_w, rmsd_w = fn(frames, boxes, invs, times)  # split inside
    mean_1, rmsd_1 = window_fn(*(torch.as_tensor(a) for a in (frames, boxes, invs, times)))
    for rm, mn in ((rmsd_s, mean_s), (rmsd_w, mean_w)):
        np.testing.assert_allclose(rm.numpy(), rmsd_1.numpy(), atol=RMSD_ATOL, rtol=0)
        assert abs(float(mn) - float(mean_1)) < 1e-6
    per_frame = sharded_window_fn(lambda *a: window_fn(*a)[1], mesh)
    assert torch.equal(per_frame(frames, boxes, invs, times), rmsd_s)

    jref, jm = jnp.asarray(frames[0]), jnp.asarray(masses)
    jr, _, _ = jax.jit(jmeasure.fit_rmsd)(jnp.asarray(frames), jref, jm)
    np.testing.assert_allclose(rmsd_s.numpy(), np.asarray(jr), atol=1e-5, rtol=0)


def test_sharded_window_fn_refuses_what_it_cannot_combine():
    with pytest.raises(ValueError) as ref:
        jmesh.sharded_window_fn(lambda *a: a, jmesh.frame_mesh(2), replicated_outs=(0,))
    with pytest.raises(ValueError, match=str(ref.value).replace("(", r"\(").replace(")", r"\)")):
        sharded_window_fn(lambda *a: a, cpus(2), replicated_outs=(0,))
    with pytest.raises(NotImplementedError, match="frame means"):
        sharded_window_fn(lambda *a: a, cpus(2), replicated_outs={0: "mean", 1: "max"},
                          n_outs=2)


# --------------------------------------------------------- MeshWindowRunner


def _jittered_xtc(path, n, n_frames, side, seed=3):
    rng = np.random.default_rng(seed)
    frames = [rng.uniform(0, side, (n, 3)).astype(np.float32)]
    for _ in range(n_frames - 1):
        frames.append(frames[-1] + rng.normal(0, 0.01, (n, 3)).astype(np.float32))
    from molar_tpu_torch.io.xtc import XtcHandler

    box = np.diag([side] * 3).astype(np.float32)
    with XtcHandler(path, "w") as w:
        for k, c in enumerate(frames):
            w.write_raw(c, box, step=k, time=float(k))


@pytest.mark.parametrize("n_dev", [2, 3])
@pytest.mark.parametrize("wire", [False, True, "delta"])
def test_runner_wire_forms_and_ragged_tail_match_jax(tmp_path, wire, n_dev):
    path = str(tmp_path / "t.xtc")
    _jittered_xtc(path, 128, 7, 4.0)
    (item,) = TrajectoryReader([path]).iter_windows(7, quantized=wire)
    coords, boxes, invs, times, _ = item
    assert type(coords) is (tuple if wire else np.ndarray)
    assert not isinstance(coords, tuple) or len(coords) == (3 if wire == "delta" else 2)

    def port_fn(transport, boxes, invs):
        c = decode_window_coords(transport)
        return {"com": c.mean(dim=1), "box": boxes[:, 0, 0]}

    runner = MeshWindowRunner(cpus(n_dev))
    got = runner.call(port_fn, coords, boxes, invs)
    whole = port_fn(*convert.transport_to_torch(item, "cpu"))
    assert got["com"].shape == (7, 3)
    for k in got:
        assert torch.equal(got[k], whole[k]), k
    shards, b, form = runner.prepare(coords, boxes, invs)
    assert b == 7 and form == ("i16" if wire else "f32") and len(shards) == n_dev
    assert sum(s[1].shape[0] for s in shards) == -(-7 // n_dev) * n_dev

    jr = jmesh.MeshWindowRunner(jmesh.frame_mesh(n_dev))
    want = jr.call(lambda c, b, i, t: ref_decode(c).mean(axis=1), coords, boxes, invs, times)
    np.testing.assert_allclose(got["com"].numpy(), np.asarray(want), rtol=REL, atol=0)


def test_runner_replicates_a_module_once_a_device():
    class Scale(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("k", torch.tensor(2.0))

        def forward(self, transport, boxes, invs):
            return transport * self.k

    mod = Scale()
    runner = MeshWindowRunner(cpus(2))
    x = np.arange(12, dtype=np.float32).reshape(4, 1, 3)
    eye = np.repeat(np.eye(3, dtype=np.float32)[None], 4, 0)
    out = runner.call(mod, x, eye, eye)
    assert torch.equal(out, torch.as_tensor(x) * 2)
    assert runner._replicas(mod, CPU) is mod  # already there: no copy
    with pytest.raises(ValueError, match="at least one"):
        MeshWindowRunner([])


def test_com_gyration_sharded_matches_jax_single_device():
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 5, (8, 64, 3)).astype(np.float32)
    masses = rng.uniform(1, 16, 64).astype(np.float32)
    grid = frame_atom_mesh(2, 2, devices=cpus(4))
    com, gyr = com_gyration_sharded(grid)(coords, masses)
    jgrid = jmesh.frame_atom_mesh(1, 1)
    cj = jax.device_put(coords, NamedSharding(jgrid, P("frames", "atoms")))
    mj = jax.device_put(masses, NamedSharding(jgrid, P("atoms")))
    jcom, jgyr = jmesh.com_gyration_sharded(jgrid)(cj, mj)
    np.testing.assert_allclose(com.numpy(), np.asarray(jcom), rtol=REL, atol=0)
    np.testing.assert_allclose(gyr.numpy(), np.asarray(jgyr), rtol=REL, atol=0)
    # a ragged split (5 frames over 2 rows, 63 atoms over 2 columns) too
    com5, gyr5 = com_gyration_sharded(grid)(coords[:5, :63], masses[:63])
    want = (coords[:5, :63] * masses[None, :63, None]).sum(1) / masses[:63].sum()
    np.testing.assert_allclose(com5.numpy(), want, rtol=1e-5, atol=0)
    assert gyr5.shape == (5,)


# --------------------------------------------------------------- callers


@pytest.fixture(scope="module")
def headline_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    n, npro, side = 1200, 120, 2.3
    box = PeriodicBox(np.diag([side] * 3))
    coords0, masses = headline.make_system(n, npro, box.matrix)
    path = str(d / "t.xtc")
    headline.write_trajectory(path, coords0, box.matrix, 9)
    return path, coords0, masses, box, npro


@pytest.mark.parametrize("n_dev", [2, 3])
def test_headline_stream_with_a_forced_retry_matches_unsharded(headline_file, n_dev):
    path, coords0, masses, box, npro = headline_file
    pidx = np.arange(npro)
    dims = grid_dims_for(box, 0.5)
    cap, tcap, cells = headline.base_caps(path, box.inv, dims, pidx)
    small = (cap // 2, tcap // 2, cells)  # tier 0 overflows, a later tier holds
    args = (path, coords0[pidx], masses[pidx], pidx, box, 0.5, dims, small, 4, "cpu")
    ids, rmsd, count, check, retried = headline.run(*args)
    mids, mrmsd, mcount, mcheck, mretried = headline.run(*args, mesh=cpus(n_dev))
    assert retried > 0 and mretried == retried
    assert np.array_equal(mids, ids) and ids.tolist() == list(range(9))
    assert np.array_equal(mcount, count) and np.array_equal(mcheck, check)
    np.testing.assert_allclose(mrmsd, rmsd, atol=RMSD_ATOL, rtol=0)


@pytest.fixture(scope="module")
def workload_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("wl")
    s = wl.synth_system(1500, 300)
    path = str(d / "w.xtc")
    wl.write_xtc(s, path, 9)
    return s, path


@pytest.mark.parametrize("name", ["ca_rmsd", "com_splits", "contacts"])
def test_workloads_through_a_mesh_match_one_device(workload_file, name):
    s, path = workload_file
    n1, _, want = wl.run(name, s, path, 4, "cpu")
    n2, _, got = wl.run(name, s, path, 4, None, mesh=cpus(2))
    assert n1 == n2 == 9
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL, abs=0), k


# --------------------------------------------------------------- membrane


def _stats(dev):
    """Every statistic of every group as {(group, species, key): (n, mean,
    m2)} (order profiles and neighbour fractions flattened)."""
    out = {}
    for gname, gr in dev.groups.items():
        for sp, st in gr.per_species.items():
            for key in ("count", "area", "tilt", "mean_curv", "gauss_curv", "n_neighbors"):
                out[(gname, sp, key)] = st[key]
            for s, acc in st["neib_fractions"].items():
                out[(gname, sp, "neib", s)] = acc
            for k, acc in enumerate(st["order"] or []):
                out[(gname, sp, "order", k)] = acc
    return out


def _assert_stats(got, want, rel):
    assert got.keys() == want.keys()
    for k, (g, w) in ((k, (got[k], want[k])) for k in want):
        assert g.n == w.n, k
        np.testing.assert_allclose(g.mean, w.mean, rtol=rel, atol=1e-12, err_msg=str(k))
        np.testing.assert_allclose(g.m2, w.m2, rtol=rel, atol=1e-12, err_msg=str(k))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_membrane_shards_merged_equal_one_pass(tmp_path, n_shards):
    # Windows of 2 frames: the shards' windows are the one pass's, so each
    # frame's outputs are the same bits and only the merge differs.
    b = wl.synth_bilayer(3, 3)
    path = str(tmp_path / "m.xtc")
    wl.write_membrane_xtc(b, path, 8)
    one = MembraneDevice(b.spec, b.coords, b.box, device="cpu")
    n1, _, want = wl.run_membrane(one, path, 2)
    shards = [MembraneDevice(b.spec, b.coords, b.box, device="cpu") for _ in range(n_shards)]
    n2, _, got = wl.run_membrane_shards(shards, path, 2)
    assert n1 == n2 == 8
    assert [s.groups["all"].per_species["LIP"]["count"].n for s in shards[1:]] == (
        [8 // n_shards] * (n_shards - 1))
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL), k
    _assert_stats(_stats(shards[0]), _stats(one), REL)
    # the same through workloads.run(mesh=)
    _, _, via_run = wl.run("membrane", b, path, 2, None, mesh=cpus(n_shards))
    assert via_run == pytest.approx(want, rel=REL)


def _ref_and_port(toml, tmp_path, groups=None, **kw):
    system = make_bilayer(**kw)
    memb = Membrane(system, toml.format(out=str(tmp_path), extra=""))
    for name, ids in (groups or {"all": range(len(memb.lipids))}).items():
        memb.add_ids_to_group(name, ids)
    ref = RefDevice(memb)
    spec, _ = convert.membrane_from_reference(ref)
    port = MembraneDevice(spec, system.state.coords, system.state.box.matrix, device="cpu")
    return system, ref, port


def test_merge_stats_from_equals_the_reference_on_the_same_outputs(tmp_path):
    system, ref_a, port_a = _ref_and_port(TOML, tmp_path)
    _, ref_b, port_b = _ref_and_port(TOML, tmp_path)
    rng = np.random.default_rng(5)
    base = system.state.coords[port_a.subset]
    windows = [np.stack([base + rng.normal(0, 0.01, base.shape).astype(np.float32)
                         for _ in range(k)]) for k in (3, 2)]
    for (ref, port), w in zip(((ref_a, port_a), (ref_b, port_b)), windows):
        outs = port.compute_window(w)
        port.accumulate(outs)
        ref.accumulate(outs)
    port_a.merge_stats_from(port_b)
    ref_a.membrane.merge_stats_from(ref_b.membrane)
    _assert_stats(_stats(port_a), _stats(ref_a.membrane), 1e-12)


def test_merge_stats_from_raises_as_the_reference(tmp_path):
    toml2 = TOML.replace('groups = ["all"]', 'groups = ["all", "upper"]')
    _, ref_a, port_a = _ref_and_port(TOML, tmp_path)
    _, ref_b, port_b = _ref_and_port(toml2, tmp_path,
                                     groups={"all": range(50), "upper": range(25)})
    with pytest.raises(RefMembraneError) as ref:
        ref_a.membrane.merge_stats_from(ref_b.membrane)
    with pytest.raises(MembraneError) as got:
        port_a.merge_stats_from(port_b)
    assert str(got.value) == str(ref.value) == "cannot merge: group names differ"
    # the same group names, other species: an empty group has none
    _, ref_c, port_c = _ref_and_port(TOML, tmp_path, groups={"all": []})
    with pytest.raises(RefMembraneError) as ref:
        ref_a.membrane.merge_stats_from(ref_c.membrane)
    with pytest.raises(MembraneError) as got:
        port_a.merge_stats_from(port_c)
    assert str(got.value) == str(ref.value) == "cannot merge group 'all': species differ"
    assert isinstance(port_a.spec, MembraneSpec)
