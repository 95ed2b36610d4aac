"""Lipid membrane analysis: the host pipeline of ``molar_tpu.membrane.membrane``
(:mod:`.membrane`), the window-batched device pipeline of
``molar_tpu.membrane.device`` (:mod:`.device`), the static structure it runs
on (:mod:`.spec`) and the group statistics both fold into (:mod:`.stats`)."""

from .device import MembraneDevice, MembraneWindow
from .membrane import LipidMolecule, LipidSpecies, Membrane, get_quad_coefs, split_leaflets
from .spec import MembraneSpec, SpeciesTemplate
from .stats import LipidGroup, MembraneError, MembraneOptions

__all__ = ["LipidGroup", "LipidMolecule", "LipidSpecies", "Membrane", "MembraneDevice",
           "MembraneError", "MembraneOptions", "MembraneSpec", "MembraneWindow",
           "SpeciesTemplate", "get_quad_coefs", "split_leaflets"]
