"""GROMACS index (.ndx) files: named atom groups.

1-based on disk, 0-based in memory (reference: molar/src/ndx_file.rs:7-60).

The port's copy of ``molar_tpu.io.ndx``.
"""

from __future__ import annotations

import re
from typing import Iterator

import numpy as np

from .base import MalformedFileError

_GROUP = re.compile(r"\[\s*(.+?)\s*\]")


class NdxFile:
    def __init__(self, groups: dict[str, np.ndarray] | str | None = None):
        # pymolar-compat: NdxFile("index.ndx") loads the file
        # (molar.pyi:179); the native form takes a groups dict.
        if isinstance(groups, str):
            groups = NdxFile.read(groups).groups
        self.groups: dict[str, np.ndarray] = groups or {}

    def get_group_as_sel(self, gr_name: str, sys):
        """The named group as a selection of ``sys`` (molar.pyi:180)."""
        return sys(self.groups[gr_name])

    @staticmethod
    def read(path: str) -> "NdxFile":
        groups: dict[str, list[int]] = {}
        current = None
        with open(path) as fh:
            for raw in fh:
                line = raw.split(";")[0].strip()
                if not line:
                    continue
                m = _GROUP.match(line)
                if m:
                    current = m.group(1)
                    groups.setdefault(current, [])
                    continue
                if current is None:
                    raise MalformedFileError(f"index data before any group in {path}")
                try:
                    groups[current].extend(int(t) - 1 for t in line.split())
                except ValueError as e:
                    raise MalformedFileError(f"bad index in group {current!r}") from e
        return NdxFile(
            {name: np.unique(np.asarray(idx, dtype=np.int64)) for name, idx in groups.items()}
        )

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            for name, idx in self.groups.items():
                fh.write(f"[ {name} ]\n")
                vals = np.asarray(idx) + 1
                for i in range(0, len(vals), 15):
                    fh.write(" ".join(str(v) for v in vals[i : i + 15]) + "\n")

    def __getitem__(self, name: str) -> np.ndarray:
        return self.groups[name]

    def __setitem__(self, name: str, idx) -> None:
        self.groups[name] = np.unique(np.asarray(idx, dtype=np.int64))

    def __contains__(self, name: str) -> bool:
        return name in self.groups

    def __iter__(self) -> Iterator[str]:
        return iter(self.groups)

    def __len__(self) -> int:
        return len(self.groups)
