"""The selection language of the port against the JAX package, on the CPU.

The port keeps its own copies of the numpy host half (parser, AST, host
evaluator, topology, interner, periodic table, host search) and rewrites the
device tier in torch (``selection/compiled.py``). They are held equal by
behaviour on the same inputs: the same AST for every text of the golden
fixtures and of the fuzz grammar, the same syntax errors, the same index
sets from the host tier on a synthetic system, and the same masks from the
device tier's window function as the JAX ``compile_device`` function (JAX on
the CPU) and the host evaluator, over a window of frames in changing boxes.
Where the JAX package is wrong the port is held to a float64 brute force or
to its host evaluator, and the JAX package's answer is pinned: a skewed box
(its length-sized grid), a non-periodic search out of the box (its wrap)
and a crowded scene (its dropped overflow flag).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import molar_tpu
from molar_tpu.core.pbc import PeriodicBox as RefBox
from molar_tpu.core.state import State as RefState
from molar_tpu.selection import SelectionExpr as RefExpr
from molar_tpu.selection.compiled import CompileUnsupported as RefUnsupported
from molar_tpu.selection.parser import SelectionSyntaxError as RefSyntaxError
from molar_tpu_torch.convert import topology_from_numpy
from molar_tpu_torch.core.pbc import PbcDims, PeriodicBox
from molar_tpu_torch.core.state import State
from molar_tpu_torch.selection import FrameSelection, SelectionExpr, SelectionSyntaxError
from molar_tpu_torch.selection.compiled import CompileUnsupported
from molar_tpu_torch.tasks.trajectory import AnalysisError

from test_selection_fuzz import _gen_expr
from torch_scenes import brute_within, dodecahedron

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GOLDEN = list(json.loads((FIXTURES / "selection_golden.json").read_text())["cases"])
GOLDEN_MULTI = sorted({t for f in json.loads((FIXTURES / "selection_golden_multi.json")
                                            .read_text())["files"].values() for t in f["cases"]})
BOX_SIDE = 4.0
N_FRAMES = 4

# Texts the golden fixtures do not cover on this system: the smoke's
# selections, a point search, the self flag on a residue that exists, cutoff
# and math ties, partial PBC and the regex anchoring.
EXTRA = [
    "name OW and within 0.5 pbc of protein",
    "within 0.5 pbc of protein",
    "resname SOL and 2.0 < z < 4.0",
    "within 1.0 pbc of [2.0, 2.0, 2.0]",
    "within 0.7 self of resid 3",
    "within 0.7 pbc self of resid 3",
    "within 0.6 of resname LIG",
    "within 0.45 pbc yny of water",
    "within 0.8 of 1.0 1.0 1.0",
    "name CA and within 0.6 pbc of chain B",
    "not within 0.5 pbc of protein",
    "protein and (x < 2.0 or within 0.4 pbc of resname LIG)",
    "x / 2 < 1.0",
    "x / 3 <= 0.5",
    "x * 2 >= y",
    "x ^ 2 > 4.0",
    "-x + 2 > 1",
    "sqrt(x^2 + y^2) < 2",
    "abs(z - 2.0) < 0.5 and mass > 12",
    "resid > 10 and x < 2.0",
    "vdw < 0.16 and y > 1.0",
    "1.0 < z <= 2.0 and noh",
    "name /C.*/",
    "name /C/",
    "same residue as within 0.5 pbc of resname LIG",
    "dist pbc point 2.0 2.0 2.0 < 1.2",
    "x > x of com pbc of resname LIG",
    "within 0.5 of com of resname LIG",
    "index 5:40 and y > y of pos 2 of name CA",
]
# The same texts' syntax errors (``tests/test_selection.py``'s cases).
BAD = ["", "nme CA", "name", "resid 1:", "(name CA", "backboneand protein", "x",
       "protein and", "proteinand water", "within of protein", "name CA and or x"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain twins run many small torch ops; on a pool of threads they
    crawl when the test workers share the cores. One thread for this
    module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the system


def _pdb_system(path) -> molar_tpu.System:
    """The fuzz tests' synthetic system with the PDB columns aligned (three
    chains of protein residues, water and ligand; 4 nm cubic box), read by
    the JAX package."""
    rng = np.random.default_rng(1234)
    lines = ["CRYST1   40.000   40.000   40.000  90.00  90.00  90.00 P 1"]
    serial = resid = 0

    def atom(rec, name, resname, chain, xyz, occ, beta, el):
        nonlocal serial
        serial += 1
        x, y, z = xyz
        lines.append(f"{rec:<6s}{serial:5d} {name:<4s} {resname:<3s} {chain}{resid:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}{occ:6.2f}{beta:6.2f}          {el:>2s}")

    protein_res = [("ALA", ["N", "CA", "C", "O", "CB", "HB1"]),
                   ("GLY", ["N", "CA", "C", "O", "HA2"]),
                   ("LYS", ["N", "CA", "C", "O", "CB", "NZ", "HZ1"])]
    for chain in "ABC":
        for _ in range(12):
            resname, names = protein_res[rng.integers(len(protein_res))]
            resid += 1
            base = rng.uniform(2.0, 38.0, 3)
            for nm in names:
                atom("ATOM", nm, resname, chain, base + rng.uniform(-1.5, 1.5, 3),
                     rng.uniform(0, 1), rng.uniform(0, 99), nm[0] if nm[0] in "NCOH" else "C")
    for _ in range(60):
        resid += 1
        base = rng.uniform(1.0, 39.0, 3)
        for nm, el in (("OW", "O"), ("HW1", "H"), ("HW2", "H")):
            atom("ATOM", nm, "SOL", "W", base + rng.uniform(-0.5, 0.5, 3), 1.0, 0.0, el)
    for _ in range(4):
        resid += 1
        base = rng.uniform(5.0, 35.0, 3)
        for nm, el in (("C1", "C"), ("C2", "C"), ("O1", "O"), ("H1", "H")):
            atom("HETATM", nm, "LIG", "L", base + rng.uniform(-1.0, 1.0, 3), 0.5, 10.0, el)
    lines.append("END")
    path.write_text("\n".join(lines) + "\n")
    return molar_tpu.System.from_file(str(path))


def port_topology(top):
    """The JAX package's topology through its columns (the slice's weights)."""
    return topology_from_numpy(top.names(), top.resnames(), top.resid, top.resindex, top.chain,
                               top.mass, top.charge, top.occupancy, top.bfactor,
                               top.atomic_number, top.bonds)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    ref = _pdb_system(tmp_path_factory.mktemp("sel") / "sys.pdb")
    top = port_topology(ref.topology)
    assert top.n_atoms == ref.n_atoms > 400
    return ref, top


def frames(coords0, n_frames=N_FRAMES, seed=0):
    """A window in changing orthorhombic boxes: each frame the coordinates
    plus N(0, 0.05) noise, scaled with the frame's box (sides x U(0.97,
    1.03) a frame, frame 0 the 4 nm box) and wrapped into it -> (coords (B,
    N, 3) f32, boxes (B, 3, 3), invs)."""
    rng = np.random.default_rng(seed)
    scale = np.concatenate([np.ones((1, 3)), rng.uniform(0.97, 1.03, (n_frames - 1, 3))])
    sides = (BOX_SIDE * scale).astype(np.float32)
    out = coords0[None] + rng.normal(0, 0.05, (n_frames, *coords0.shape))
    out[0] = coords0
    out = (out * scale[:, None, :]).astype(np.float32) % sides[:, None, :]
    boxes = np.stack([np.diag(s) for s in sides]).astype(np.float32)
    return out.astype(np.float32), boxes, np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)


def host_sets(evaluate, coords, boxes):
    return [evaluate(coords[f], boxes[f]) for f in range(coords.shape[0])]


def port_host(text, top):
    expr = SelectionExpr(text)
    return lambda c, b: expr.apply(top, State(coords=c, box=PeriodicBox(b)))


def ref_host(text, ref):
    expr = RefExpr(text)
    return lambda c, b: expr.apply(ref.topology, RefState(coords=c, box=RefBox(b)))


def _outcome(fn):
    """An evaluation's sorted indices, or the name of the error it raised."""
    try:
        return fn()
    except (ValueError, RuntimeError, ZeroDivisionError) as e:
        return type(e).__name__


# ---------------------------------------------------------------- the parser


def same_ast(a, b) -> bool:
    """Structural equality across the two packages' node classes: the same
    class names, fields equal recursively, enums by name and value, arrays
    elementwise."""
    if dataclasses.is_dataclass(a):
        return (dataclasses.is_dataclass(b) and type(a).__name__ == type(b).__name__
                and all(same_ast(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(a)))
    if isinstance(a, enum.Enum):
        return (isinstance(b, enum.Enum) and type(a).__name__ == type(b).__name__
                and a.name == b.name and a.value == b.value)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_ast(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def fuzz_texts(seed, n=50):
    rng = np.random.default_rng(seed)
    return [_gen_expr(rng) for _ in range(n)]


@pytest.mark.parametrize("text", GOLDEN + GOLDEN_MULTI + EXTRA)
def test_ast_equals_the_reference(text):
    assert same_ast(SelectionExpr(text).ast, RefExpr(text).ast)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_ast_equals_the_reference_on_fuzz_texts(seed):
    texts = fuzz_texts(seed)
    assert all(same_ast(SelectionExpr(t).ast, RefExpr(t).ast) for t in texts)


def test_same_ast_tells_trees_apart():
    assert not same_ast(SelectionExpr("within 0.5 of name CA").ast,
                        RefExpr("within 0.5 pbc of name CA").ast)
    assert not same_ast(SelectionExpr("x < 1.0").ast, RefExpr("x <= 1.0").ast)
    assert not same_ast(SelectionExpr("within 1 of [1, 2, 3]").ast,
                        RefExpr("within 1 of [1, 2, 4]").ast)


@pytest.mark.parametrize("text", BAD)
def test_syntax_errors_as_the_reference(text):
    with pytest.raises(RefSyntaxError) as want:
        RefExpr(text)
    with pytest.raises(SelectionSyntaxError) as got:
        SelectionExpr(text)
    assert (got.value.offset, got.value.expected) == (want.value.offset, want.value.expected)


# ---------------------------------------------------------------- host tier


@pytest.mark.parametrize("text", GOLDEN + GOLDEN_MULTI + EXTRA)
def test_host_tier_equals_the_reference(system, text):
    ref, top = system
    coords, boxes, _ = frames(ref.state.coords, 2, seed=5)
    port, want = port_host(text, top), ref_host(text, ref)
    for f in range(2):
        got = _outcome(lambda: port(coords[f], boxes[f]))
        exp = _outcome(lambda: want(coords[f], boxes[f]))
        if isinstance(exp, str):
            assert got == exp, text
        else:
            np.testing.assert_array_equal(got, exp, err_msg=text)


def test_host_tier_equals_the_reference_on_fuzz_texts(system):
    ref, top = system
    coords, boxes, _ = frames(ref.state.coords, 1, seed=6)
    for text in fuzz_texts(21, 60):
        got = _outcome(lambda: port_host(text, top)(coords[0], boxes[0]))
        exp = _outcome(lambda: ref_host(text, ref)(coords[0], boxes[0]))
        if isinstance(exp, str):
            assert got == exp, text
        else:
            np.testing.assert_array_equal(got, exp, err_msg=text)


# ---------------------------------------------------------------- device tier


def _tier(fs_ref_ctor):
    try:
        return fs_ref_ctor()
    except RefUnsupported:
        return None


DEVICE_TEXTS = [t for t in GOLDEN + EXTRA if SelectionExpr(t).is_state_dependent]

# The texts held against the JAX function itself (one jit each, JAX-CPU):
# the smoke's selections, the self flag, partial and no PBC, a point, and
# the math grammar.
JAX_TEXTS = [
    "name OW and within 0.5 pbc of protein",
    "within 1.0 pbc of [2.0, 2.0, 2.0]",
    "resname SOL and 2.0 < z < 4.0",
    "within 0.7 self of resid 3 or within 0.45 pbc yny of water",
    "within 0.6 of resname LIG or within 0.8 of 1.0 1.0 1.0",
    "protein and (x < 2.0 or not within 0.4 pbc self of resname LIG)",
    "x * 2 >= y and -x + 2 > 1 or x ^ 2 > 4.0 and vdw < 0.16 or 2.0 <= x <= 4.0 and resid > 10"
    " or x / 2 < 1.0 or sqrt(x^2 + y^2) < 2",
]


def _window_masks(fs, coords, boxes, invs):
    masks, overflow = fs.compiled(*(torch.from_numpy(a) for a in (coords, boxes, invs)))
    assert masks.shape == (coords.shape[0], fs.topology.n_atoms) and masks.dtype == torch.bool
    assert overflow.shape == (coords.shape[0],) and not overflow.any()
    return masks.numpy()


@pytest.mark.parametrize("text", DEVICE_TEXTS)
def test_device_tier_equals_the_host_tiers(system, text):
    """The compiled window function on torch-CPU, over 4 frames in changing
    boxes, against the port's host evaluator (equal to the JAX package's:
    ``test_host_tier_equals_the_reference``) frame by frame; the tier and
    ``CompileUnsupported`` as in the JAX package."""
    ref, top = system
    st0 = State(coords=ref.state.coords, box=PeriodicBox(ref.state.box.matrix))
    fs = FrameSelection(text, top, st0, device="cpu")
    comp_ref = _tier(lambda: RefExpr(text).compile_device(ref.topology, ref.state))
    assert fs.tier == ("device" if comp_ref is not None else "host"), text
    if comp_ref is None:
        with pytest.raises(CompileUnsupported):
            SelectionExpr(text).compile_device(top, st0, device="cpu")
        return
    coords, boxes, invs = frames(ref.state.coords)
    masks = _window_masks(fs, coords, boxes, invs)
    host = host_sets(port_host(text, top), coords, boxes)
    for f in range(N_FRAMES):
        np.testing.assert_array_equal(np.flatnonzero(masks[f]), host[f], err_msg=text)
    np.testing.assert_array_equal(fs.eval_window(coords, boxes, invs), masks)
    np.testing.assert_array_equal(
        fs.eval_frame(State(coords=coords[2], box=PeriodicBox(boxes[2]))), host[2])


@pytest.mark.parametrize("text", JAX_TEXTS)
def test_device_tier_equals_the_jax_function(system, text):
    """The port's window function against the JAX ``compile_device``
    function, vmapped over the same window and jitted (JAX-CPU), mask for
    mask, and both against the host evaluator."""
    ref, top = system
    st0 = State(coords=ref.state.coords, box=PeriodicBox(ref.state.box.matrix))
    fs = FrameSelection(text, top, st0, device="cpu")
    assert fs.tier == "device"
    coords, boxes, invs = frames(ref.state.coords, seed=1)
    masks = _window_masks(fs, coords, boxes, invs)
    comp = RefExpr(text).compile_device(ref.topology, ref.state)
    want = np.asarray(jax.jit(jax.vmap(comp))(jnp.asarray(coords), jnp.asarray(boxes),
                                              jnp.asarray(invs)))
    np.testing.assert_array_equal(masks, want, err_msg=text)
    host = host_sets(ref_host(text, ref), coords, boxes)
    assert all(np.array_equal(np.flatnonzero(masks[f]), host[f]) for f in range(N_FRAMES))
    assert masks.any(axis=1).all() and not masks.all(axis=1).any()


def test_tiers_and_unsupported_as_the_reference_on_fuzz_texts(system):
    ref, top = system
    st0 = State(coords=ref.state.coords, box=PeriodicBox(ref.state.box.matrix))
    tiers = {}
    for text in fuzz_texts(31, 80):
        fs = FrameSelection(text, top, st0, device="cpu")
        if not RefExpr(text).is_state_dependent:
            want = "static"
        else:
            ok = _tier(lambda: RefExpr(text).compile_device(ref.topology, ref.state))
            want = "device" if ok is not None else "host"
        assert fs.tier == want, text
        tiers[want] = tiers.get(want, 0) + 1
    assert min(tiers.values()) >= 5, tiers


def test_fuzz_texts_compiled_equal_the_host_evaluator(system):
    """Compiled fuzz texts over a 2-frame window against the port's host
    evaluator (the ``test_selection_fuzz`` contract, on the port)."""
    ref, top = system
    st0 = State(coords=ref.state.coords, box=PeriodicBox(ref.state.box.matrix))
    coords, boxes, invs = frames(ref.state.coords, 2, seed=9)
    n_device = 0
    for text in fuzz_texts(41, 80):
        fs = FrameSelection(text, top, st0, device="cpu")
        if fs.tier != "device":
            continue
        n_device += 1
        masks = fs.eval_window(coords, boxes, invs)
        host = host_sets(port_host(text, top), coords, boxes)
        for f in range(2):
            np.testing.assert_array_equal(np.flatnonzero(masks[f]), host[f], err_msg=text)
    assert n_device >= 20


def test_division_is_true_division_at_ties(system):
    """``x / 2 < 1.0`` and ``x / 3 <= 0.5`` at coordinates that are exact
    ties (x = 2.0, x = 1.5): a constant divisor divides (a product by a
    rounded reciprocal would move 1.5 / 3 off 0.5)."""
    ref, top = system
    coords = ref.state.coords.copy()
    coords[:6, 0] = [2.0, 1.5, 2.0 - 2**-22, 1.5 + 2**-22, 0.3, 3.3]
    box = np.diag([BOX_SIDE] * 3).astype(np.float32)
    st = State(coords=coords, box=PeriodicBox(box))
    inv = np.linalg.inv(box)
    ref_st = RefState(coords=coords, box=RefBox(box))
    for text in ("x / 2 < 1.0", "x / 3 <= 0.5", "x / 0.3 >= 1.0", "x / 1.1 == 3.0"):
        fs = FrameSelection(text, top, st, device="cpu")
        got = fs.eval_window(coords[None], box[None], inv[None])[0]
        comp = RefExpr(text).compile_device(ref.topology, ref_st)
        want = np.asarray(comp(jnp.asarray(coords), jnp.asarray(box), jnp.asarray(inv)))
        np.testing.assert_array_equal(got, want, err_msg=text)
        np.testing.assert_array_equal(SelectionExpr(text).apply(top, st),
                                      RefExpr(text).apply(ref.topology, ref_st), err_msg=text)
    # f32 on the device, f64 on the host (both packages): 3.3f / 1.1 ties
    # only in f32.
    assert got[5] and 5 not in SelectionExpr("x / 1.1 == 3.0").apply(top, st)
    assert torch.div(torch.tensor([1.5]), torch.tensor(3.0)).item() == 0.5


def test_empty_target_selects_nothing(system):
    ref, top = system
    st0 = State(coords=ref.state.coords, box=PeriodicBox(ref.state.box.matrix))
    fs = FrameSelection("within 0.5 pbc of resname ZZZ or x < 0.0", top, st0, device="cpu")
    coords, boxes, invs = frames(ref.state.coords, 2)
    assert fs.tier == "device" and not fs.eval_window(coords, boxes, invs).any()


# ---------------------------------------------------------------- skewed box


D, CUTOFF = 3.0, 0.5


@pytest.fixture(scope="module")
def dodeca():
    """1,909 atoms uniform in a rhombic dodecahedron (d = 3 nm): a 50-atom
    residue 1 ("LIG"), the rest water triplets."""
    m = dodecahedron(D)
    rng = np.random.default_rng(3)
    n = int(round(100.0 * abs(np.linalg.det(m.astype(np.float64))))) // 3 * 3 + 50
    coords = (rng.uniform(0, 1, (n, 3)) @ m.T.astype(np.float64)).astype(np.float32)
    names = ["C1"] * 50 + ["OW", "HW1", "HW2"] * ((n - 50) // 3)
    resnames = ["LIG"] * 50 + ["SOL"] * (n - 50)
    resid = np.concatenate([np.ones(50, np.int64), 2 + np.arange(n - 50) // 3])
    top = topology_from_numpy(names, resnames, resid, resid - 1, ["A"] * n, np.ones(n),
                              np.zeros(n), np.ones(n), np.zeros(n), np.full(n, 8))
    return coords, m, top


def test_skewed_box_equals_the_brute_force(dodeca):
    """``within 0.5 pbc of resid 1`` in the dodecahedron: the device tier
    (correction route, grid from the cell heights) and the host tier equal a
    float64 brute force over the lattice images, on a window of 3 frames
    whose boxes breathe."""
    coords0, m, top = dodeca
    text = "within 0.5 pbc of resid 1"
    st0 = State(coords=coords0, box=PeriodicBox(m))
    fs = FrameSelection(text, top, st0, device="cpu")
    assert fs.tier == "device"
    rng = np.random.default_rng(4)
    scale = np.array([1.0, 1.01, 0.99], np.float32)
    boxes = (m[None] * scale[:, None, None]).astype(np.float32)
    invs = np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)
    coords = (coords0[None] + rng.normal(0, 0.05, (3, *coords0.shape))) * scale[:, None, None]
    coords = coords.astype(np.float32)
    masks = fs.eval_window(coords, boxes, invs)
    for f in range(3):
        want, dmin = brute_within(coords[f], np.arange(len(coords0)), np.arange(50), boxes[f],
                                  CUTOFF)
        assert np.abs(dmin / CUTOFF - 1).min() > 1e-5  # no tie within f32 rounding
        np.testing.assert_array_equal(masks[f], want)
        host = SelectionExpr(text).apply(top, State(coords=coords[f], box=PeriodicBox(boxes[f])))
        np.testing.assert_array_equal(host, np.flatnonzero(want))


def test_reference_misses_atoms_in_the_dodecahedron(dodeca):
    """The JAX package's fault, pinned: its compiled search and its host
    search size the grid from the vector lengths (6^3 cells at d = 3 nm,
    thinner than the cutoff) and both miss atoms the brute force finds;
    neither reports a false hit."""
    coords0, m, top = dodeca
    text = "within 0.5 pbc of resid 1"
    want, _ = brute_within(coords0, np.arange(len(coords0)), np.arange(50), m, CUTOFF)
    ref_top = molar_tpu.core.topology.Topology.from_atoms([
        molar_tpu.core.atom.Atom(name=str(nm), resname=str(rn), resid=int(r))
        for nm, rn, r in zip(top.names(), top.resnames(), top.resid)])
    ref_state = RefState(coords=coords0, box=RefBox(m))
    comp = jax.jit(RefExpr(text).compile_device(ref_top, ref_state))
    got_dev = np.asarray(comp(jnp.asarray(coords0), jnp.asarray(m), jnp.asarray(
        ref_state.box.inv)))
    got_host = np.zeros(len(coords0), bool)
    got_host[RefExpr(text).apply(ref_top, ref_state)] = True
    for got in (got_dev, got_host):
        assert not (got & ~want).any() and (want & ~got).sum() > 0


# ---------------------------------------------------------------- overflow


def test_overflow_is_flagged_and_retried(system):
    """``cap`` 4 on the 4 nm box: the window function raises the flag of
    the frames that overflow, and ``eval_window`` re-runs the window at
    larger caps and returns the host evaluator's sets. The JAX function
    drops the flag."""
    ref, top = system
    text = "within 0.5 pbc of protein"
    st0 = State(coords=ref.state.coords, box=PeriodicBox(ref.state.box.matrix))
    fs = FrameSelection(text, top, st0, cutoff_params={"cap": 4, "tgt_cap": 4}, device="cpu")
    coords, boxes, invs = frames(ref.state.coords)
    _, overflow = fs.compiled(*(torch.from_numpy(a) for a in (coords, boxes, invs)))
    assert overflow.all()
    masks = fs.eval_window(coords, boxes, invs)
    assert sorted(fs._tiers) == [0, 1, 2]
    host = host_sets(port_host(text, top), coords, boxes)
    for f in range(N_FRAMES):
        np.testing.assert_array_equal(np.flatnonzero(masks[f]), host[f])
    comp = RefExpr(text).compile_device(ref.topology, ref.state, {"cap": 4, "tgt_cap": 4})
    out = jax.eval_shape(comp, *(jnp.asarray(a[0]) for a in (coords, boxes, invs)))
    assert out.shape == (top.n_atoms,)  # a mask and no flag


def test_overflow_beyond_the_last_tier_raises(system):
    ref, top = system
    st0 = State(coords=ref.state.coords, box=PeriodicBox(ref.state.box.matrix))
    fs = FrameSelection("within 0.5 pbc of protein", top, st0, cutoff_params={"cap": 1},
                        device="cpu")
    coords, boxes, invs = frames(ref.state.coords, 1)
    with pytest.raises(AnalysisError, match="still overflows"):
        fs.eval_window(coords, boxes, invs)


# ---------------------------------------------------------------- non-periodic


def test_nonperiodic_within_out_of_the_box(system):
    """A non-periodic ``within`` of an unwrapped protein that sticks out of
    the box on both sides, and one periodic in y only: the port's device
    tier bins each frame's non-periodic axes in their own coordinate span
    and equals its host evaluator (and the JAX host evaluator). The JAX
    compiled function wraps the atoms out of the box into it, and its set
    differs: pinned."""
    ref, top = system
    coords0 = ref.state.coords.copy()
    prot = np.flatnonzero(np.isin(ref.topology.resnames(), ["ALA", "GLY", "LYS"]))
    coords0[prot[: len(prot) // 2], 0] -= 1.2   # out of the box below x = 0
    coords0[prot[len(prot) // 2:], 2] += 1.3   # and beyond z = 4
    box = np.diag([BOX_SIDE] * 3).astype(np.float32)
    inv = np.linalg.inv(box)
    texts = ["within 0.6 of protein", "within 0.45 self of resname LIG",
             "within 0.8 of 0.0 2.0 4.5", "within 0.5 pbc nyn of protein"]
    st0 = State(coords=coords0, box=PeriodicBox(box))
    rng = np.random.default_rng(8)
    coords = (coords0[None] + rng.normal(0, 0.05, (3, *coords0.shape))).astype(np.float32)
    boxes, invs = np.repeat(box[None], 3, 0), np.repeat(inv[None], 3, 0)
    ref_state = RefState(coords=coords0, box=RefBox(box))
    for text in texts:
        fs = FrameSelection(text, top, st0, device="cpu")
        assert fs.tier == "device" and fs.compiled.uses_box == ("pbc" in text)
        masks = fs.eval_window(coords, boxes, invs)
        for f in range(3):
            want = SelectionExpr(text).apply(top, State(coords=coords[f], box=PeriodicBox(box)))
            np.testing.assert_array_equal(np.flatnonzero(masks[f]), want, err_msg=text)
            np.testing.assert_array_equal(want, RefExpr(text).apply(ref.topology, RefState(
                coords=coords[f], box=RefBox(box))), err_msg=text)
        if text == texts[0]:
            comp = jax.jit(RefExpr(text).compile_device(ref.topology, ref_state))
            got = np.asarray(comp(jnp.asarray(coords[0]), jnp.asarray(box), jnp.asarray(inv)))
            jax_differs = int((got != masks[0]).sum())
    assert jax_differs > 0


def test_partial_pbc_in_a_skewed_box_takes_the_host_tier(dodeca):
    """``pbc yny`` in the dodecahedron: the port leaves it to the host tier
    (the non-periodic axis is not separable from the lattice), where the
    JAX package compiles it and wraps every axis. Pinned: the host search
    of both packages bins the non-periodic axis in lab coordinates while
    the box vector c moves an image along it, so it misses atoms that the
    all-pairs evaluation of its own distance (rounding on the periodic
    axes, no corrections) finds, and reports no false hit."""
    coords0, m, top = dodeca
    text = "within 0.5 pbc yny of resid 1"
    fs = FrameSelection(text, top, State(coords=coords0, box=PeriodicBox(m)), device="cpu")
    assert fs.tier == "host"
    ref_top = molar_tpu.core.topology.Topology.from_atoms([
        molar_tpu.core.atom.Atom(name=str(nm), resname=str(rn), resid=int(r))
        for nm, rn, r in zip(top.names(), top.resnames(), top.resid)])
    ref_state = RefState(coords=coords0, box=RefBox(m))
    RefExpr(text).compile_device(ref_top, ref_state)  # compiles: no CompileUnsupported
    got = fs.eval_window(coords0[None], m[None], np.linalg.inv(m)[None])[0]
    d = PeriodicBox(m).shortest_vector(coords0[:, None, :] - coords0[None, :50, :],
                                       PbcDims.from_str("yny"))
    want = ((d.astype(np.float64) ** 2).sum(-1) <= CUTOFF**2).any(1)
    assert not (got & ~want).any() and (want & ~got).sum() > 0


def test_device_tier_needs_the_card_unless_told(system):
    """Without a card a state-dependent selection raises unless the caller
    names the CPU: no fallback. A static one needs no device."""
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    ref, top = system
    st0 = State(coords=ref.state.coords, box=PeriodicBox(ref.state.box.matrix))
    for text in ("x < 1.0", "within 0.5 pbc of protein", "x > x of com of name CA"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FrameSelection(text, top, st0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SelectionExpr(text).compile_device(top, st0)
    assert FrameSelection("name CA", top, st0).tier == "static"


def test_host_pair_search_equals_the_reference_and_the_brute_force(system, dodeca):
    """``ops/neighbor_host.search_pairs``, the host ground truth of pair
    lists: the JAX package's pairs on the orthorhombic system (double and
    single set, PBC and none), and in the dodecahedron, where the JAX
    package's length-sized grid misses pairs, the float64 brute force."""
    from molar_tpu.ops import neighbor_host as ref_nh
    from molar_tpu_torch.ops import neighbor_host as nh
    from molar_tpu.core.pbc import PBC_FULL as REF_FULL, PBC_NONE as REF_NONE
    from molar_tpu_torch.core.pbc import PBC_FULL, PBC_NONE

    def pairs(out):
        return sorted(map(tuple, np.asarray(out[0]).tolist()))

    ref, _ = system
    c = ref.state.coords
    idx1, idx2 = np.arange(0, 200), np.arange(150, 420)
    for i2 in (idx2, None):
        for pbc, ref_pbc in ((PBC_FULL, REF_FULL), (PBC_NONE, REF_NONE)):
            got = nh.search_pairs(0.45, c, idx1, i2, PeriodicBox(ref.state.box.matrix), pbc)
            want = ref_nh.search_pairs(0.45, c, idx1, i2, ref.state.box, ref_pbc)
            assert pairs(got) == pairs(want) and len(pairs(got)) > 0
            np.testing.assert_allclose(np.sort(got[1]), np.sort(want[1]), rtol=1e-6)
    coords0, m, _ = dodeca
    got = nh.search_pairs(CUTOFF, coords0, np.arange(50), np.arange(50, 900), PeriodicBox(m),
                          PBC_FULL)
    hit, _ = brute_within(coords0, np.arange(50, 900), np.arange(50), m, CUTOFF)
    assert sorted({j for _, j in pairs(got)}) == (50 + np.flatnonzero(hit)).tolist()
