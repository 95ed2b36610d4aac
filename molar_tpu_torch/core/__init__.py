from .pbc import PeriodicBox, PeriodicBoxError, mat3_apply

__all__ = ["PeriodicBox", "PeriodicBoxError", "mat3_apply"]
