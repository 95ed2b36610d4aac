from .pbc import PBC_FULL, PBC_NONE, PbcDims, PeriodicBox, PeriodicBoxError, mat3_apply

__all__ = ["PBC_FULL", "PBC_NONE", "PbcDims", "PeriodicBox", "PeriodicBoxError", "mat3_apply"]
