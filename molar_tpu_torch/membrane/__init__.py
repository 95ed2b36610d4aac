"""Lipid membrane analysis on torch: the window-batched device pipeline of
``molar_tpu.membrane.device`` (:mod:`.device`), the static structure it runs
on (:mod:`.spec`) and the group statistics it folds into (:mod:`.stats`)."""

from .device import MembraneDevice, MembraneWindow
from .spec import MembraneSpec, SpeciesTemplate, leaflets
from .stats import LipidGroup, MembraneError, MembraneOptions

__all__ = ["LipidGroup", "MembraneDevice", "MembraneError", "MembraneOptions", "MembraneSpec",
           "MembraneWindow", "SpeciesTemplate", "leaflets"]
