"""trjconv, the DCD handler, ``decode_prefix``, the ``molar-torch`` CLI and
``FrameBatch`` of the port against the JAX package's, on the CPU.

Small XTC files (600 atoms, 7 frames; an orthorhombic, a triclinic and a
zero box) are written by the port. The prefix decode gives the full
decode's first rows; the port's ``trjconv`` writes the same bytes as
``molar_tpu.io.trjconv`` for a protein-first contiguous selection, a
contiguous one further in, a scattered one, all atoms and a frame range;
the DCD reader gives what the JAX package's reads, also from a file
without unit cells; ``cli.main(["trjconv", ...])`` on a GRO writes the
bytes and prints the line of the JAX ``molar trjconv``; ``info`` without a
card exits 1; ``FrameBatch.from_states`` equals the JAX one field by field.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
import torch

import molar_tpu
import molar_tpu.cli as ref_cli
from molar_tpu.core.system import SelectionError
from molar_tpu.core.state import FrameBatch as RefFrameBatch
from molar_tpu.core.state import State as RefState
from molar_tpu.io.dcd import DcdHandler as RefDcd
from molar_tpu.io.trjconv import trjconv as ref_trjconv
from molar_tpu.io.xtc import XtcHandler as RefXtc
from molar_tpu_torch import cli
from molar_tpu_torch.convert import topology_from_numpy
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.core.state import FrameBatch, State
from molar_tpu_torch.io.dcd import DcdHandler
from molar_tpu_torch.io.gro import write_gro
from molar_tpu_torch.io.trjconv import trjconv
from molar_tpu_torch.io.xtc import XtcHandler

N_ATOMS, N_FRAMES, SIDE = 600, 7, 4.0
BOXES = {
    "cubic": np.diag([SIDE] * 3).astype(np.float32),
    "triclinic": np.array([[SIDE, 0.3, 1.0], [0, SIDE, 0.5], [0, 0, 3.8]], np.float32),
    "zero": None,
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topology():
    """200 ALA residues of CA / CB / N (the protein, first), then nothing
    else: the selections pick rows of it."""
    names = ["CA", "CB", "N"] * (N_ATOMS // 3)
    resid = 1 + np.arange(N_ATOMS) // 3
    resname = ["ALA"] * 300 + ["SOL"] * 300
    return topology_from_numpy(names, resname, resid, resid - 1, ["A"] * N_ATOMS,
                               np.full(N_ATOMS, 12.0), np.zeros(N_ATOMS), np.ones(N_ATOMS),
                               np.zeros(N_ATOMS), np.full(N_ATOMS, 6))


@pytest.fixture(scope="module")
def xtc_files(tmp_path_factory):
    """box kind -> (XTC path, the written frames (F, N, 3), the box)."""
    d = tmp_path_factory.mktemp("trjconv")
    rng = np.random.default_rng(1)
    c = rng.uniform(0, SIDE, (N_ATOMS, 3)).astype(np.float32)
    frames = []
    for _ in range(N_FRAMES):
        c = c + rng.normal(0, 0.02, c.shape).astype(np.float32)
        frames.append(c)
    out = {}
    for kind, box in BOXES.items():
        path = str(d / f"{kind}.xtc")
        with XtcHandler(path, "w") as w:
            for k, f in enumerate(frames):
                w.write_raw(f, box, step=10 * k, time=2.0 * k)
        out[kind] = (path, np.stack(frames), box)
    return out


@pytest.mark.parametrize("frame", [0, 3, N_FRAMES - 1])
@pytest.mark.parametrize("n_want", [1, 17, 300, N_ATOMS])
def test_decode_prefix_equals_the_full_decode(xtc_files, frame, n_want):
    path = xtc_files["cubic"][0]
    with XtcHandler(path) as r, RefXtc(path) as theirs:
        full = r.read_frame(frame)
        rows, step, time, box9 = r.decode_prefix(frame, n_want)
        assert rows.shape == (n_want, 3) and rows.dtype == np.float32
        assert np.array_equal(rows, full.coords[:n_want])
        assert (step, time) == (full.step, full.time)
        want = theirs.decode_prefix(frame, n_want)
        assert np.array_equal(rows, want[0]) and (step, time) == want[1:3]
        assert np.array_equal(box9, want[3])


def test_decode_prefix_reuses_its_buffer(xtc_files):
    with XtcHandler(xtc_files["cubic"][0]) as r:
        buf = np.empty((100 + XtcHandler.PREFIX_SLACK, 3), np.float32)
        a, *_ = r.decode_prefix(0, 100, buf)
        assert a.base is buf
        first = a.copy()
        b, *_ = r.decode_prefix(1, 100, buf)
        assert b.base is buf and not np.array_equal(first, b)
        with pytest.raises(ValueError, match="coords_out"):
            r.decode_prefix(0, 100, np.empty((100, 3), np.float32))


CASES = {
    "protein_first": (np.arange(0, 300), {}),
    "contiguous_inside": (np.arange(120, 420), {}),
    "scattered": (np.array([5, 2, 300, 17, 599]), {}),
    "all_atoms": (None, {}),
    "frame_range": (np.arange(0, 300), {"first": 1, "last": 6, "step": 2}),
    "past_the_end": (np.array([7, 8, 9]), {"first": 5, "last": 50}),
}


@pytest.mark.parametrize("kind", sorted(BOXES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_trjconv_bytes_equal_the_reference(xtc_files, tmp_path, kind, case):
    path = xtc_files[kind][0]
    idx, kw = CASES[case]
    mine, theirs = str(tmp_path / "mine.dcd"), str(tmp_path / "theirs.dcd")
    n = trjconv(path, mine, idx, **kw)
    assert n == ref_trjconv(path, theirs, idx, **kw)
    assert n == len(range(kw.get("first", 0), min(kw.get("last", N_FRAMES), N_FRAMES),
                          kw.get("step", 1)))
    assert open(mine, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("bad", [np.array([], np.int64), np.array([0, N_ATOMS])])
def test_trjconv_refuses_bad_selections(xtc_files, tmp_path, bad):
    with pytest.raises(ValueError):
        trjconv(xtc_files["cubic"][0], str(tmp_path / "o.dcd"), bad)


@pytest.mark.parametrize("kind", sorted(BOXES))
def test_dcd_reader_round_trips(xtc_files, tmp_path, kind):
    path, frames, box = xtc_files[kind]
    out = str(tmp_path / "o.dcd")
    idx = np.array([3, 1, 400, 250])
    trjconv(path, out, idx)
    with DcdHandler(out) as mine:
        theirs = RefDcd(out)
        try:
            assert (mine.n_frames, mine.n_atoms) == (theirs.n_frames, theirs.n_atoms)
            assert mine.n_frames == N_FRAMES and mine.n_atoms == len(idx)
            for k in range(N_FRAMES):
                a, b = mine.read_frame(k), theirs.read_frame(k)
                assert np.array_equal(a.coords, b.coords) and a.time == b.time
                assert np.abs(a.coords - frames[k][idx]).max() < 2e-3  # XTC precision
                assert (a.box is None) == (b.box is None) == (box is None)
                if box is not None:
                    assert np.array_equal(a.box.matrix, b.box.matrix)
                    assert np.abs(a.box.matrix - box).max() < 1e-5
        finally:
            theirs.close()


@pytest.mark.parametrize("kind", sorted(BOXES))
def test_dcd_write_bytes_equal_the_reference(xtc_files, tmp_path, kind):
    """The per-frame ``write`` (a state's box through lengths and angles)."""
    _, frames, box = xtc_files[kind]
    idx = np.arange(10, 40)
    mine, theirs = str(tmp_path / "mine.dcd"), str(tmp_path / "theirs.dcd")
    top = molar_tpu.core.topology.Topology(N_ATOMS)
    with DcdHandler(mine, "w") as w:
        for f in frames:
            w.write(None, State(coords=f, box=None if box is None else PeriodicBox(box)), idx)
    w2 = RefDcd(theirs, "w")
    for f in frames:
        w2.write(top, RefState(coords=f, box=None if box is None else molar_tpu.PeriodicBox(box)),
                 indices=idx)
    w2.close()
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    with DcdHandler(mine) as r, pytest.raises(Exception, match="read-only"):
        r.write(None, State(coords=frames[0]))


def test_dcd_reader_reads_a_file_without_unit_cells(xtc_files, tmp_path):
    """The layout ``benchmarks/native_workloads.cpp``'s trjconv writes: frame
    count and CHARMM flag in the header, no unit-cell records."""
    frames = xtc_files["cubic"][1][:, :5] * np.float32(10)
    path = tmp_path / "native.dcd"

    def rec(payload):
        return struct.pack("<I", len(payload)) + payload + struct.pack("<I", len(payload))

    hdr = bytearray(84)
    hdr[0:4] = b"CORD"
    hdr[4:8] = struct.pack("<I", len(frames))
    hdr[80:84] = struct.pack("<I", 24)
    body = rec(bytes(hdr)) + rec(struct.pack("<I", 1) + b"native trjconv".ljust(80, b"\0"))
    body += rec(struct.pack("<I", 5))
    for f in frames:
        body += b"".join(rec(np.ascontiguousarray(f[:, d]).tobytes()) for d in range(3))
    path.write_bytes(body)
    with DcdHandler(str(path)) as mine:
        theirs = RefDcd(str(path))
        try:
            assert mine.n_frames == theirs.n_frames == N_FRAMES and mine.n_atoms == 5
            for k in range(N_FRAMES):
                a, b = mine.read_frame(k), theirs.read_frame(k)
                assert a.box is None and b.box is None
                assert np.array_equal(a.coords, b.coords)
        finally:
            theirs.close()


@pytest.fixture(scope="module")
def gro_file(xtc_files, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "conf.gro")
    _, frames, box = xtc_files["cubic"]
    write_gro(path, _topology(), State(coords=frames[0], box=PeriodicBox(box)))
    return path


@pytest.mark.parametrize("argv", [
    ["--select", "resname ALA"],
    ["--select", "name CA and resid 10:120"],
    ["--select", "name CB", "-b", "1", "-e", "6", "--skip", "2"],
    [],
])
def test_cli_trjconv_equals_the_reference_cli(xtc_files, gro_file, tmp_path, capsys, argv):
    xtc = xtc_files["cubic"][0]
    mine, theirs = str(tmp_path / "mine.dcd"), str(tmp_path / "theirs.dcd")
    assert cli.main(["trjconv", "-s", gro_file, "-f", xtc, "-o", mine, *argv]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert ref_cli.main(["trjconv", "-s", gro_file, "-f", xtc, "-o", theirs, *argv]) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == want.replace(theirs, mine)
    assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_cli_trjconv_refuses_an_empty_selection(xtc_files, gro_file, tmp_path, capsys):
    """Exit 1 with ``cmd_trjconv``'s message. The JAX CLI never reaches its
    own check: its ``System.__call__`` raises on an empty selection first."""
    argv = ["trjconv", "-s", gro_file, "-f", xtc_files["cubic"][0], "-o",
            str(tmp_path / "o.dcd"), "--select", "resname XYZ"]
    assert cli.main(argv) == 1
    assert "error: selection 'resname XYZ' matched no atoms" in capsys.readouterr().err
    with pytest.raises(SelectionError, match="empty"):
        ref_cli.main(argv)


def test_cli_trjconv_names_an_unported_structure_format(xtc_files, tmp_path):
    with pytest.raises(NotImplementedError, match="tpr"):
        cli.main(["trjconv", "-s", str(tmp_path / "conf.tpr"), "-f", xtc_files["cubic"][0],
                  "-o", str(tmp_path / "o.dcd")])


def test_cli_info_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["info"]) == 1
    out, err = capsys.readouterr()
    assert "no CUDA device" in err and "torch " in out and "cpu" not in out.lower().split(
        "torch ")[0]
    assert "devices" not in out


def test_cli_without_a_command_prints_help(capsys):
    assert cli.main([]) == 1
    assert "trjconv" in capsys.readouterr().out


def _states(kind):
    """Three frames in both packages: orthorhombic boxes, no box, or a
    triclinic box on the second frame."""
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 3, (3, 50, 3)).astype(np.float32)
    boxes = {
        "padded": [np.diag([3.0, 3.1, 3.2]), np.diag([3.0, 3.0, 3.0]), np.diag([2.9] * 3)],
        "boxless": [None, None, None],
        "triclinic": [np.diag([3.0] * 3), BOXES["triclinic"], None],
    }[kind]
    mine = [State(coords=c, time=1.5 * k, box=None if b is None else PeriodicBox(b))
            for k, (c, b) in enumerate(zip(coords, boxes))]
    theirs = [RefState(coords=c, time=1.5 * k,
                       box=None if b is None else molar_tpu.PeriodicBox(b))
              for k, (c, b) in enumerate(zip(coords, boxes))]
    return mine, theirs


@pytest.mark.parametrize("kind,pad_to", [("padded", 5), ("boxless", None), ("boxless", 4),
                                         ("triclinic", None), ("triclinic", 6)])
def test_frame_batch_equals_the_reference(kind, pad_to):
    mine, theirs = _states(kind)
    got = FrameBatch.from_states(mine, pad_to=pad_to)
    want = RefFrameBatch.from_states(theirs, pad_to=pad_to)
    assert got.n_frames == want.n_frames == (pad_to or 3)
    for name in ("coords", "boxes", "box_invs", "times", "valid", "corrections"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert isinstance(a, torch.Tensor) and a.numpy().dtype == np.asarray(b).dtype, name
            assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert (got.corrections is not None) == (kind == "triclinic")
    moved = got.to("cpu")
    assert moved.n_frames == got.n_frames and torch.equal(moved.coords, got.coords)
    assert (moved.corrections is None) == (got.corrections is None)


def test_frame_batch_refuses_a_short_pad():
    with pytest.raises(ValueError, match="pad_to"):
        FrameBatch.from_states(_states("padded")[0], pad_to=2)
