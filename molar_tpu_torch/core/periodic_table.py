"""Periodic table: element symbols, masses, van der Waals radii.

Numeric parity with the reference tables (molar/src/periodic_table.rs:1-86) is a
correctness requirement: vdW radii feed the ``vdw`` selection keyword and the
vdW-cutoff distance-search variants, and masses feed COM/inertia. The vdW set is
Bondi 1964 with H from Rowland & Taylor 1996, 2.00 A default, and CHARMM27-based
ionic radii for Na/K/Cl/Ca/Mg/Cs.

Units: masses in amu; the radii table is stored in Angstrom and scaled to nm at
lookup (reference: molar/src/atom.rs:91-94), unknown element (Z=0) -> 0.15 nm.

The port's own copy of ``molar_tpu.core.periodic_table`` (numpy only; the port imports
nothing of the JAX package), held equal to it by behaviour in
``tests/test_torch_selection.py``.
"""

from __future__ import annotations

import numpy as np

from ..config import NP_FLOAT as FLOAT

#: Element symbols indexed by atomic number; index 0 is the unknown element "X".
ELEMENT_NAMES: tuple[str, ...] = (
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc",
    "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge",
    "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc",
    "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn", "Sb", "Te", "I", "Xe",
    "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb",
    "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os",
    "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr",
    "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt",
    "Ds", "Rg",
)

NUM_ELEMENTS = len(ELEMENT_NAMES)  # 112

ELEMENT_NAMES_UPPER: tuple[str, ...] = tuple(s.upper() for s in ELEMENT_NAMES)

#: Standard atomic weights (amu), indexed by atomic number; 0.0 for "X".
ELEMENT_MASSES = np.array(
    [
        0.0, 1.00794, 4.00260, 6.941, 9.012182, 10.811,
        12.0107, 14.0067, 15.9994, 18.9984032, 20.1797,
        22.989770, 24.3050, 26.981538, 28.0855, 30.973761,
        32.065, 35.453, 39.948, 39.0983, 40.078, 44.955910,
        47.867, 50.9415, 51.9961, 54.938049, 55.845, 58.9332,
        58.6934, 63.546, 65.409, 69.723, 72.64, 74.92160,
        78.96, 79.904, 83.798, 85.4678, 87.62, 88.90585,
        91.224, 92.90638, 95.94, 98.0, 101.07, 102.90550,
        106.42, 107.8682, 112.411, 114.818, 118.710, 121.760,
        127.60, 126.90447, 131.293, 132.90545, 137.327,
        138.9055, 140.116, 140.90765, 144.24, 145.0, 150.36,
        151.964, 157.25, 158.92534, 162.500, 164.93032,
        167.259, 168.93421, 173.04, 174.967, 178.49, 180.9479,
        183.84, 186.207, 190.23, 192.217, 195.078, 196.96655,
        200.59, 204.3833, 207.2, 208.98038, 209.0, 210.0, 222.0,
        223.0, 226.0, 227.0, 232.0381, 231.03588, 238.02891,
        237.0, 244.0, 243.0, 247.0, 247.0, 251.0, 252.0, 257.0,
        258.0, 259.0, 262.0, 261.0, 262.0, 266.0, 264.0, 269.0,
        268.0, 271.0, 272.0,
    ],
    dtype=FLOAT,
)

#: van der Waals radii in Angstrom, indexed by atomic number; 1.5 A for "X".
ELEMENT_VDW_ANGSTROM = np.array(
    [
        1.5, 1.2, 1.4, 1.82, 2.0, 2.0,
        1.7, 1.55, 1.52, 1.47, 1.54,
        1.36, 1.18, 2.0, 2.1, 1.8,
        1.8, 2.27, 1.88, 1.76, 1.37, 2.0,
        2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
        1.63, 1.4, 1.39, 1.07, 2.0, 1.85,
        1.9, 1.85, 2.02, 2.0, 2.0, 2.0,
        2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
        1.63, 1.72, 1.58, 1.93, 2.17, 2.0,
        2.06, 1.98, 2.16, 2.1, 2.0,
        2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
        2.0, 2.0, 2.0, 2.0, 2.0,
        2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
        2.0, 2.0, 2.0, 2.0, 1.72, 1.66,
        1.55, 1.96, 2.02, 2.0, 2.0, 2.0, 2.0,
        2.0, 2.0, 2.0, 2.0, 2.0, 1.86,
        2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
        2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0,
        2.0, 2.0, 2.0,
    ],
    dtype=FLOAT,
)

assert ELEMENT_MASSES.shape[0] == NUM_ELEMENTS
assert ELEMENT_VDW_ANGSTROM.shape[0] == NUM_ELEMENTS

#: van der Waals radii in nm (the library's length unit), indexed by atomic number.
ELEMENT_VDW_NM = (ELEMENT_VDW_ANGSTROM * FLOAT(0.1)).astype(FLOAT)

_SYMBOL_TO_Z = {s: z for z, s in enumerate(ELEMENT_NAMES_UPPER)}


def vdw_radius(atomic_number: int) -> float:
    """vdW radius in nm for an atomic number; 0.15 nm for the unknown element."""
    if 0 <= atomic_number < NUM_ELEMENTS:
        return float(ELEMENT_VDW_NM[atomic_number])
    return 0.15


def mass_of(atomic_number: int) -> float:
    """Standard atomic weight in amu; 0.0 for the unknown element."""
    if 0 <= atomic_number < NUM_ELEMENTS:
        return float(ELEMENT_MASSES[atomic_number])
    return 0.0


def atomic_number_from_symbol(symbol: str) -> int:
    """Resolve an *explicit* element symbol ("Cl", "SE", "c") to Z, else 0.

    Use when the source states the element outright (PDB element column
    77-78); an explicit symbol always beats name-based guessing (reference:
    molar/src/atom.rs:327 and the "SG is not seaborgium" rule). A blank
    field means "not stated" and yields 0.
    """
    up = symbol.strip().upper()
    if not up:
        return 0
    return _SYMBOL_TO_Z.get(up, 0)


def element_symbol(atomic_number: int) -> str:
    """Mixed-case element symbol for Z; '' when unknown/out of range."""
    if 1 <= atomic_number < NUM_ELEMENTS:
        return ELEMENT_NAMES[atomic_number]
    return ""


def guess_element_from_name(name: str, resname: str = "") -> int:
    """Guess atomic number from an atom *name* (PDB/GRO style).

    Mirrors the reference's disambiguation rules (molar/src/atom.rs:238-285):

    * leading digits are skipped; a name with no letters yields 0;
    * "SOD"/"POT" map to Na/K (CHARMM ion names);
    * a two-letter element match starting with C/N/O/H/P (CA, CL, NA...) is only
      accepted when ``name == resname`` (free ions), because a protein "CA" is an
      alpha carbon, not calcium;
    * otherwise fall back to single-letter matching on the first letter.
    """
    i = next((k for k, c in enumerate(name) if c.isalpha()), None)
    if i is None:
        return 0
    if name == "SOD":
        return 11
    if name == "POT":
        return 19
    if i + 1 < len(name):
        two = name[i : i + 2].upper()
        z = _SYMBOL_TO_Z.get(two, 0)
        if z and len(ELEMENT_NAMES_UPPER[z]) == 2:
            if two[0] in "CNOHP":
                if name == resname:
                    return z
            else:
                return z
    # Single-letter matching is case-sensitive in the reference (all one-letter
    # symbols are uppercase), two-letter matching is case-insensitive.
    one = name[i]
    z = _SYMBOL_TO_Z.get(one, 0)
    if z and len(ELEMENT_NAMES_UPPER[z]) == 1:
        return z
    return 0
