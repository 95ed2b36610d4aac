"""Port vs JAX package: the four selection workloads, end to end on the CPU.

A 2,000-atom system with a 400-atom protein and a 24-frame trajectory,
made from seeds, goes through ``molar_tpu_torch.workloads.run`` (CPU
tensors) and through ``benchmarks/workloads.py``'s ``wl_*`` functions on
JAX-CPU at two window sizes (16 leaves a short last window): the check
scalars agree within 1e-5 relative; the per-frame results agree with the
JAX functions applied frame by frame (RMSD and gyration 1e-5, contact
counts equal); the sidecar is byte-identical; the native C++ program's
scalars are within ``CHECK_RTOL``. Also here: subset windows equal slices of
full windows, the overflow retry re-reads the same rows, and
``auto_window``'s rounding rules.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from molar_tpu.ops import measure as jmeasure
from molar_tpu.ops import neighbor as jnb
from molar_tpu.tasks import trajectory as jtraj

from molar_tpu_torch import convert
from molar_tpu_torch import workloads as wl
from molar_tpu_torch.io.base import MalformedFileError
from molar_tpu_torch.tasks import trajectory as traj

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))

import workloads as ref_wl  # noqa: E402

N_ATOMS, N_PROTEIN, N_FRAMES = 2000, 400, 24
RTOL = 1e-5
NAMES = sorted(n for n in wl.WORKLOADS if n != "membrane")  # membrane: test_torch_membrane


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    system = wl.synth_system(N_ATOMS, N_PROTEIN)
    xtc = str(tmp_path_factory.mktemp("wl") / "traj.xtc")
    wl.write_xtc(system, xtc, N_FRAMES)
    return system, ref_wl._synth_system(N_ATOMS, N_PROTEIN), xtc


@pytest.fixture(scope="module")
def frames(case):
    """Every frame of the file, decoded to float32 on the host."""
    _, _, xtc = case
    (coords, boxes, invs, _, _), = traj.TrajectoryReader([xtc]).iter_windows(N_FRAMES)
    return coords, boxes, invs


def _stream(name, system, xtc, window):
    """Per-frame results of workload ``name`` streamed on the CPU."""
    model, subset = convert.workload_from_numpy(name, system, "cpu")
    pipe = traj.WindowPipeline(traj.TrajectoryReader([xtc]), window, model, "cpu",
                               quantized="delta", subset=subset)
    outs = [res for _, res in pipe.run()]
    return [torch.cat(col).numpy() for col in zip(*outs)]


def test_tf32_is_off_in_these_comparisons():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("n_atoms,n_protein,seed", [(N_ATOMS, N_PROTEIN, 0), (611, 102, 3)])
def test_synth_system_equals_the_reference(n_atoms, n_protein, seed):
    got = wl.synth_system(n_atoms, n_protein, seed=seed)
    want = ref_wl._synth_system(n_atoms, n_protein, seed=seed)
    ca, ala, ow = want("name CA"), want("resname ALA"), want("name OW")
    np.testing.assert_array_equal(got.coords, want.state.coords)
    np.testing.assert_array_equal(got.box, want.state.box.matrix)
    np.testing.assert_array_equal(got.masses[got.ca], ca.masses)
    np.testing.assert_array_equal(got.masses[got.protein], ala.masses)
    np.testing.assert_array_equal(got.masses[got.ow], ow.masses)
    assert got.masses.dtype == ca.masses.dtype and got.coords.dtype == np.float32
    for mine, theirs in ((got.ca, ca.indices), (got.protein, ala.indices), (got.ow, ow.indices),
                         (got.ligand, ow.indices[:50]), (got.segment_ids, ala.segment_ids())):
        np.testing.assert_array_equal(mine, theirs)
    assert got.segment_ids.dtype == ala.segment_ids().dtype
    assert got.n_atoms == want.n_atoms == n_atoms


def test_write_xtc_equals_the_reference(case, tmp_path):
    system, ref_system, xtc = case
    theirs = str(tmp_path / "ref.xtc")
    ref_wl._write_xtc(ref_system, theirs, N_FRAMES)
    with open(xtc, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("window", [16, 8])
@pytest.mark.parametrize("name", NAMES)
def test_check_scalars_match_the_reference_workload(case, name, window):
    system, ref_system, xtc = case
    n, seconds, got = wl.run(name, system, xtc, window, "cpu")
    rn, _, want = getattr(ref_wl, f"wl_{name}")(ref_system, xtc, window)
    assert n == rn == N_FRAMES and seconds > 0
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(got[key] - want[key]) <= RTOL * abs(want[key]), (key, got[key], want[key])


@pytest.mark.parametrize("window", [16, 5])
def test_per_frame_results_match_the_jax_functions(case, frames, window):
    system, _, xtc = case
    coords, boxes, invs = frames
    ca = jnp.asarray(system.ca)
    want_rmsd = np.asarray(jmeasure.fit_rmsd(
        jnp.asarray(coords)[:, ca], jnp.asarray(system.coords)[ca],
        jnp.asarray(system.masses)[ca])[0])
    idx, w, _ = jmeasure.contiguous_segments_dense(system.segment_ids,
                                                   system.masses[system.protein])
    want_com, want_gyr = (np.asarray(x) for x in jmeasure.dense_segment_com_gyration(
        jnp.asarray(coords[:, system.protein]), jnp.asarray(idx), jnp.asarray(w)))
    want_count = np.array([int(jnb.contact_pairs_dense(
        jnp.asarray(coords[f]), jnp.asarray(system.protein), jnp.asarray(system.ligand),
        cutoff=wl.CUTOFF, box=jnp.asarray(boxes[f]), inv=jnp.asarray(invs[f]),
        max_pairs=wl.MAX_PAIRS)[2]) for f in range(N_FRAMES)])
    assert want_count.sum() > 50

    (rmsd,) = _stream("ca_rmsd", system, xtc, window)
    com, gyr = _stream("com_splits", system, xtc, window)
    count, overflow = _stream("contacts", system, xtc, window)
    np.testing.assert_allclose(rmsd, want_rmsd, atol=1e-5, rtol=0)
    np.testing.assert_allclose(com, want_com, atol=0, rtol=RTOL)
    np.testing.assert_allclose(gyr, want_gyr, atol=0, rtol=RTOL)
    np.testing.assert_array_equal(count, want_count)
    assert not overflow.any()
    # The fused program gives the same numbers from the union's rows.
    frmsd, fgyr, fcount, foverflow = _stream("fused", system, xtc, window)
    np.testing.assert_array_equal(frmsd, rmsd)
    np.testing.assert_array_equal(fgyr, gyr)
    np.testing.assert_array_equal(fcount, count)
    assert not foverflow.any()


def test_contact_lists_are_the_global_pairs(case, frames):
    # The module's rows are subset-local; mapped back through the subset
    # they are the JAX function's global pairs.
    system, _, xtc = case
    coords, boxes, invs = frames
    model, subset = convert.workload_from_numpy("contacts", system, "cpu")
    sub = torch.from_numpy(coords[:4, subset])
    pairs, dist, count, _ = model.pairs(sub, torch.from_numpy(boxes[:4]),
                                        torch.from_numpy(invs[:4]))
    for f in range(4):
        want = np.asarray(jnb.contact_pairs_dense(
            jnp.asarray(coords[f]), jnp.asarray(system.protein), jnp.asarray(system.ligand),
            cutoff=wl.CUTOFF, box=jnp.asarray(boxes[f]), inv=jnp.asarray(invs[f]),
            max_pairs=wl.MAX_PAIRS)[0])
        n = int(count[f])
        np.testing.assert_array_equal(subset[pairs[f, :n].numpy()], want[:n])
        assert (want[n:] == -1).all() and (pairs[f, n:] == -1).all()


def test_grid_route_equals_dense_route(case, monkeypatch):
    system, _, xtc = case
    dense = _stream("contacts", system, xtc, 16)
    monkeypatch.setattr(wl, "DENSE_LIMIT", 0)
    model, _ = convert.workload_from_numpy("contacts", system, "cpu")
    assert not model.dense and model.dims == (20, 20, 20)
    grid = _stream("contacts", system, xtc, 16)
    np.testing.assert_array_equal(grid[0], dense[0])
    assert not grid[1].any()


def test_run_raises_on_overflow_and_on_no_contact(case, monkeypatch):
    system, _, xtc = case
    monkeypatch.setattr(wl, "MAX_PAIRS", 2)
    with pytest.raises(traj.AnalysisError, match="overflowed"):
        wl.run("contacts", system, xtc, 16, "cpu")
    monkeypatch.setattr(wl, "MAX_PAIRS", 1 << 14)
    monkeypatch.setattr(wl, "CUTOFF", 1e-4)
    with pytest.raises(traj.AnalysisError, match="no contact"):
        wl.run("fused", system, xtc, 16, "cpu")
    with pytest.raises(ValueError, match="workload must be one of"):
        wl.run("trjconv", system, xtc, 16, "cpu")


def test_native_meta_bytes_equal_the_reference(case, tmp_path):
    system, ref_system, _ = case
    mine, theirs = str(tmp_path / "a.meta"), str(tmp_path / "b.meta")
    wl.write_native_meta(system, mine)
    ref_wl._write_native_meta(ref_system, theirs)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", NAMES)
def test_check_scalars_match_the_native_program(case, name, tmp_path):
    system, _, xtc = case
    meta = str(tmp_path / "traj.meta")
    wl.write_native_meta(system, meta)
    native = wl.run_native(name, xtc, meta)
    assert native["workload"] == wl.WORKLOADS[name] and native["frames"] == N_FRAMES
    _, _, checks = wl.run(name, system, xtc, 16, "cpu")
    assert wl.native_mismatches(checks, native) == []
    assert wl.CHECK_RTOL == ref_wl.CHECK_RTOL["ca_rmsd"]
    broken = {k: v * (1 + 2 * wl.CHECK_RTOL) for k, v in checks.items()}
    assert len(wl.native_mismatches(broken, native)) == len(checks)


@pytest.mark.parametrize("quantized", [False, True, "delta"])
def test_subset_windows_equal_slices_of_full_windows(case, quantized):
    system, _, xtc = case
    # A prefix subset (decoded as a prefix) and one that reaches the last atom.
    for subset in (np.concatenate([system.protein, system.ligand]),
                   np.array([3, 700, 1999])):
        def decoded(sub):
            got = []
            pipe = traj.WindowPipeline(
                traj.TrajectoryReader([xtc]), 10,
                lambda t, b, i: (traj.decode_window_coords(t), b, i), "cpu",
                quantized=quantized, subset=sub)
            for ids, res in pipe.run():
                got.append((ids, *res))
            return got

        full, part = decoded(None), decoded(subset)
        assert [len(w[0]) for w in part] == [10, 10, 4]
        for (fi, fc, fb, fv), (pi, pc, pb, pv) in zip(full, part):
            np.testing.assert_array_equal(fi, pi)
            assert pc.shape == (len(pi), len(subset), 3) and pc.dtype == torch.float32
            assert torch.equal(pc, fc[:, subset])
            assert torch.equal(pb, fb) and torch.equal(pv, fv)


def test_overflow_retry_rereads_the_same_rows(case):
    system, _, xtc = case
    subset = system.ca
    seen = []

    def build(tier):
        def fn(transport, boxes, invs):
            coords = traj.decode_window_coords(transport)
            seen.append((tier, coords.shape[1]))
            # tier 0 "overflows" on the second window only
            flag = torch.full((coords.shape[0],), tier == 0 and len(seen) == 2)
            return coords, flag
        return fn

    results, retried = traj.run_with_overflow_retry(
        traj.TrajectoryReader([xtc]), 16, build, "cpu", overflow_of=lambda r: r[1],
        quantized="delta", subset=subset)
    assert retried == 1 and seen == [(0, 100), (0, 100), (1, 100)]
    (full, _, _, _, _), = traj.TrajectoryReader([xtc]).iter_windows(N_FRAMES)
    got = torch.cat([res[0] for _, res in results]).numpy()
    np.testing.assert_array_equal(got, full[:, subset])
    assert not results[1][1][1].any()


@pytest.mark.parametrize("rows,target,max_window,want,want_jax", [
    (100, 6_000_000, 128, 24, 24),    # longer than the file: the file's frames
    (100, 3 * 100 * 20, 128, 16, 16),  # 20 -> a multiple of 16
    (100, 3 * 100 * 15, 128, 8, 8),   # below 16: a power of two
    (100, 3 * 100 * 3, 128, 8, 2),    # ... but not below AUTO_WINDOW_MIN
    (100, 10, 128, 8, 1),
    (None, 3 * 2000 * 17, 128, 16, 16),  # every atom
    (400, 6_000_000, 16, 16, 16),     # clamped to max_window
])
def test_auto_window_rounding_rules(case, rows, target, max_window, want, want_jax):
    _, _, xtc = case
    subset = None if rows is None else np.arange(rows)
    # ``target`` counts the JAX package's 3 bytes a row a frame; the port
    # counts the bytes of the wire form it ships. Frame for frame the rules
    # are the same, but for the port's floor of AUTO_WINDOW_MIN frames (the
    # JAX package falls to 1; the H100 sweep of phase 16 set the floor).
    mine = target * traj.WIRE_BYTES[traj.WIRE] // 3
    got = traj.auto_window(xtc, subset, target_bytes=mine, max_window=max_window)
    assert got == want == max(want_jax, min(traj.AUTO_WINDOW_MIN, N_FRAMES))
    assert jtraj.auto_window(xtc, subset, target_bytes=target, max_window=max_window) == want_jax
    assert traj.auto_window(xtc, subset, requested=7, target_bytes=mine) == 7


def test_auto_window_raises_on_what_is_not_an_xtc(tmp_path):
    with pytest.raises(NotImplementedError, match="'trr' format is not yet ported"):
        traj.auto_window(str(tmp_path / "frames.trr"))
    other = tmp_path / "frames.dcd"
    other.write_bytes(b"CORD")
    with pytest.raises(MalformedFileError, match="not a dcd file"):
        traj.auto_window(str(other))
    with pytest.raises(Exception) as err:
        traj.auto_window(str(tmp_path / "missing.xtc"))
    assert not isinstance(err.value, NotImplementedError)
    assert traj.AUTO_WINDOW_MAX % 16 == 0 and traj.AUTO_WINDOW_TARGET_BYTES > 0
