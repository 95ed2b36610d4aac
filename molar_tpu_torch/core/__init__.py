from .atom import AROMATIC, IN_RING, Atom, BondOrder
from .interner import NamePool
from .pbc import PBC_FULL, PBC_NONE, PbcDims, PeriodicBox, PeriodicBoxError, mat3_apply
from .state import FrameBatch, State, make_fake_state
from .topology import Adjacency, Topology, TopologyError

__all__ = ["AROMATIC", "IN_RING", "Atom", "BondOrder", "NamePool", "PBC_FULL", "PBC_NONE",
           "PbcDims", "PeriodicBox", "PeriodicBoxError", "mat3_apply", "FrameBatch", "State",
           "make_fake_state", "Adjacency", "Topology", "TopologyError"]
