"""A membrane from a user's TOML: ``MembraneSpec.from_toml`` and ``split_leaflets``.

On each scene of ``tests/test_torch_membrane.py`` (``make_bilayer`` with
that scene's TOML), the port's spec built from the TOML on the port's own
``System`` equals the spec of the reference ``MembraneDevice(Membrane(
system, text))`` (``convert.membrane_from_reference``): every index array,
the masses and the species' tails exactly, the options and the groups (a
named group starts empty, no ``groups`` gives "all" every lipid). The
reference's errors come with its messages: no lipid matched (a species
whose ``whole`` matches nothing or does not parse is skipped), a tail
string without its first or its last carbon. The port's leaflet split
(``split_leaflets`` of the port's ``Membrane``) equals the JAX ``membrane``
command's (``molar_tpu/cli.py:256-266``) on two-leaflet bilayers. One window through a ``MembraneDevice`` built from the TOML
equals the JAX ``MembraneDevice``'s within ``tests/torch_scenes``'s
``MEMBRANE_BARS``, and its check scalars are within ``MEMBRANE_TOL``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from molar_tpu.membrane import Membrane
from molar_tpu.membrane import MembraneError as RefMembraneError
from molar_tpu.membrane.device import MembraneDevice as RefDevice

from molar_tpu_torch import convert
from molar_tpu_torch import workloads as wl
from molar_tpu_torch.core.pbc import PeriodicBox
from molar_tpu_torch.core.state import State
from molar_tpu_torch.core.system import System
from molar_tpu_torch.membrane import (Membrane as PortMembrane, MembraneDevice, MembraneError,
                                      MembraneSpec, split_leaflets)

from test_membrane_device import TOML, make_bilayer
from test_torch_membrane import SCENES, _system
from torch_scenes import membrane_diffs, membrane_within_bars

OUT = "/nonexistent"  # no statistics files are written

TWO_LEAFLETS = TOML.replace('groups = ["all"]', 'groups = ["upper", "lower"]')
NO_GROUPS = TOML.replace('groups = ["all"]\n', "")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops; one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_system(ref_system) -> System:
    """The port's ``System`` of a reference one, column by column."""
    top = ref_system.topology
    ptop = convert.topology_from_numpy(
        top.names(), top.resnames(), top.resid, top.resindex, top.chain, top.mass, top.charge,
        top.occupancy, top.bfactor, top.atomic_number)
    box = ref_system.state.box
    return System(ptop, State(coords=ref_system.state.coords.copy(),
                              box=None if box is None else PeriodicBox(box.matrix)))


def _text(toml):
    return toml.format(out=OUT, extra="") if "{out}" in toml else toml


def _scene(name):
    toml, kw, _, _ = SCENES[name]
    kw = {k: v for k, v in kw.items() if k != "cap"}
    species = kw.pop("species", False)
    return _system(species, **kw), toml.format(out=OUT)


def _assert_specs_equal(got: MembraneSpec, want: MembraneSpec):
    for f in ("subset", "first", "atom_first", "masses", "species_of"):
        a, b = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(a, b, err_msg=f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
    for f in ("head", "mid", "tail"):
        for a, b in zip(getattr(got, f), getattr(want, f)):
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype == np.int32, f
    assert got.species_names == want.species_names
    assert got.sp_lipids.keys() == want.sp_lipids.keys()
    for sp in want.sp_lipids:
        np.testing.assert_array_equal(got.sp_lipids[sp], want.sp_lipids[sp])
        assert len(got.sp_tails[sp]) == len(want.sp_tails[sp])
        for (ga, go), (wa, wo) in zip(got.sp_tails[sp], want.sp_tails[sp]):
            np.testing.assert_array_equal(ga, wa)
            assert go == wo and ga.dtype == wa.dtype
    assert got.triclinic == want.triclinic
    assert got.groups == want.groups
    for f in dataclasses.fields(want.options):
        a, b = getattr(got.options, f.name), getattr(want.options, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def _reference_spec(system, text):
    return convert.membrane_from_reference(RefDevice(Membrane(system, text)))[0]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_spec_from_toml_equals_the_reference(name):
    system, text = _scene(name)
    got = MembraneSpec.from_toml(port_system(system), text)
    _assert_specs_equal(got, _reference_spec(system, text))


@pytest.mark.parametrize("toml", [NO_GROUPS, TWO_LEAFLETS,
                                  TOML.replace('sel = "all"', 'sel = "resid 1:30"'),
                                  TOML.replace('"name P"', '"name P G"')])
def test_spec_groups_selection_and_markers_follow_the_reference(toml):
    system = make_bilayer()
    text = _text(toml)
    got = MembraneSpec.from_toml(port_system(system), text)
    _assert_specs_equal(got, _reference_spec(system, text))
    if toml is NO_GROUPS:
        assert got.groups == {"all": list(range(50))}


def test_a_species_that_fails_or_matches_nothing_is_skipped():
    system = _system(True)
    for broken in ('whole = "resname LIQ and ("', 'whole = "resname NONE"'):
        text = SCENES["two_species"][0].replace('whole = "resname LIQ"', broken)
        got = MembraneSpec.from_toml(port_system(system), text)
        assert got.species_names == ["LIP"]
        _assert_specs_equal(got, _reference_spec(system, text))


@pytest.mark.parametrize("change", [
    ('whole = "resname LIP"', 'whole = "resname XYZ"'),
    ('whole = "resname LIP"', 'whole = "resname LIP and ("'),
    ('"C1-C2-C3-C4"', '"-C1-C2"'),
    ('"C1-C2-C3-C4"', '"C1=C2-"'),
    ('"C1-C2-C3-C4"', '"C1-=C2"'),
])
def test_errors_are_the_reference_errors(change):
    system = make_bilayer()
    text = _text(TOML.replace(*change))
    with pytest.raises(RefMembraneError) as want:
        Membrane(system, text)
    with pytest.raises(MembraneError) as got:
        MembraneSpec.from_toml(port_system(system), text)
    assert str(got.value) == str(want.value)


def _reference_leaflets(system, text):
    """``molar_tpu/cli.py:256-266``, on a copy of the system."""
    memb = Membrane(system, text)
    for lip in memb.lipids:
        lip.update_markers(system)
    z0 = float(np.median([l.head_marker[2] for l in memb.lipids]))
    return ([l.id for l in memb.lipids if l.head_marker[2] > z0],
            [l.id for l in memb.lipids if l.head_marker[2] <= z0])


@pytest.mark.parametrize("kw", [{}, {"tilt": 0.9}, {"bend": 0.4, "seed": 3},
                                {"nx": 4, "ny": 3}])
def test_leaflets_equal_the_reference_split(kw):
    system = make_bilayer(**kw)
    text = _text(TWO_LEAFLETS)
    # shift the bilayer across the box's z edge so lipids wrap
    coords = system.state.coords.copy()
    coords[:, 2] += 4.5
    system.state.coords = coords
    memb = PortMembrane(port_system(system), text)
    upper, lower = split_leaflets(memb)
    want = _reference_leaflets(system, text)
    assert (upper, lower) == want
    assert len(upper) == len(lower) == len(memb.lipids) // 2
    assert memb.groups["upper"].lipid_ids == upper and memb.groups["lower"].lipid_ids == lower


def test_one_window_from_toml_equals_the_jax_device():
    system = make_bilayer()
    text = _text(TWO_LEAFLETS)
    port_sys = port_system(system)
    spec = MembraneSpec.from_toml(port_sys, text)
    upper, lower = split_leaflets(PortMembrane(port_system(system), text))
    spec.groups.update(upper=upper, lower=lower)
    dev = MembraneDevice(spec, port_sys.state.coords, port_sys.state.box.matrix, device="cpu")

    memb = Membrane(system, text)
    memb.add_ids_to_group("upper", upper)
    memb.add_ids_to_group("lower", lower)
    ref = RefDevice(memb)
    assert dev.patch_cap == ref.patch_cap
    rng = np.random.default_rng(4)
    base = system.state.coords[spec.subset]
    window = np.stack([base + rng.normal(0, 0.01, base.shape).astype(np.float32)
                       for _ in range(3)])
    got, want = dev.compute_window(window), ref.compute_window(window)
    diffs = membrane_diffs(want, got, spec.sp_lipids)
    assert membrane_within_bars(diffs), diffs
    gchk = wl._checks("membrane", [got], spec)
    wchk = wl._checks("membrane", [{k: np.asarray(v) if k != "order" else
                                    {s: [np.asarray(t) for t in ts] for s, ts in v.items()}
                                    for k, v in want.items()}], spec)
    assert not wl.membrane_mismatches(gchk, wchk), (gchk, wchk)
    dev.accumulate(got)
    ref.accumulate(got)
    for name in ("upper", "lower"):
        g, w = dev.groups[name], memb.groups[name]
        assert g.lipid_ids == w.lipid_ids and g.species_names == w.species_names
        assert g.per_species["LIP"]["area"].mean == w.per_species["LIP"]["area"].mean
