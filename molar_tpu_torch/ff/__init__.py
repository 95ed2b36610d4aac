"""Force-field pieces of the port: GAFF / GAFF2 atom typing (:mod:`.gaff`)
and espaloma partial charges (:mod:`.espaloma`)."""

from .gaff import FFError, apply_ff, gaff_types, parse_def

__all__ = ["FFError", "apply_ff", "gaff_types", "parse_def"]
