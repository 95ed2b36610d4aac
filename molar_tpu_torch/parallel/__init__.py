"""Frames sharded over several devices (:mod:`.mesh`)."""

from .mesh import (
    MeshWindowRunner,
    com_gyration_sharded,
    frame_atom_mesh,
    frame_mesh,
    frame_sharding,
    pad_to_multiple,
    replicated_sharding,
    shard_window,
    sharded_window_fn,
)

__all__ = [
    "MeshWindowRunner",
    "com_gyration_sharded",
    "frame_atom_mesh",
    "frame_mesh",
    "frame_sharding",
    "pad_to_multiple",
    "replicated_sharding",
    "shard_window",
    "sharded_window_fn",
]
