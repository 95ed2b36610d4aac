"""What the membrane pipelines fold their results into, on the host.

Jax-free copies of ``molar_tpu.membrane.membrane``'s options and group
statistics (the port never imports ``molar_tpu``): :class:`MembraneOptions`
with the same defaults and TOML keys, the Welford accumulator
:class:`_RunningStats`, :class:`LipidGroup` with the same statistics and
the same output files, and the tilt angle of ``membrane/device.py``. The
host :class:`~.membrane.Membrane` folds a frame in with
``LipidGroup.frame_update``; ``MembraneDevice.accumulate`` folds a window
of the device pipeline into the same groups.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class MembraneError(RuntimeError):
    pass


@dataclass
class MembraneOptions:
    sel: str = "all"
    cutoff: float = 2.5
    max_smooth_iter: int = 1
    order_type: str = "scdcorr"
    output_dir: str = "."
    global_normal: Optional[np.ndarray] = None
    n_shells_patch: int = 0
    n_shells_smoothing: int = 0
    lipids: dict = field(default_factory=dict)
    groups: list = field(default_factory=list)

    @staticmethod
    def from_toml(text: str) -> "MembraneOptions":
        data = tomllib.loads(text)
        opts = MembraneOptions()
        for key in (
            "sel",
            "cutoff",
            "max_smooth_iter",
            "output_dir",
            "n_shells_patch",
            "n_shells_smoothing",
            "groups",
        ):
            if key in data:
                setattr(opts, key, data[key])
        if "order_type" in data:
            opts.order_type = str(data["order_type"]).lower()
        if "global_normal" in data:
            opts.global_normal = np.asarray(data["global_normal"], dtype=np.float64)
        opts.lipids = data.get("lipids", {})
        return opts


class _RunningStats:
    """Welford mean/std accumulator."""

    def __init__(self, shape=()):
        self.n = 0
        self.mean = np.zeros(shape)
        self.m2 = np.zeros(shape)

    def add(self, x):
        x = np.asarray(x, dtype=np.float64)
        self.n += 1
        d = x - self.mean
        self.mean = self.mean + d / self.n
        self.m2 = self.m2 + d * (x - self.mean)

    @property
    def std(self):
        return np.sqrt(self.m2 / self.n) if self.n > 1 else np.zeros_like(self.mean)

    def merge(self, other: "_RunningStats") -> None:
        """Fold another accumulator in (Chan et al. parallel variance):
        exact aggregation of statistics gathered over disjoint frames."""
        if other.n == 0:
            return
        if self.n == 0:
            self.n, self.mean, self.m2 = other.n, other.mean.copy(), other.m2.copy()
            return
        n = self.n + other.n
        d = other.mean - self.mean
        self.mean = self.mean + d * (other.n / n)
        self.m2 = self.m2 + other.m2 + d * d * (self.n * other.n / n)
        self.n = n


class LipidGroup:
    """Named lipid container with per-species running statistics."""

    def __init__(self, name: str, lipid_ids=None, species_names=None):
        self.name = name
        self.lipid_ids = list(lipid_ids or [])
        self.species_names = sorted(set(species_names or []))
        self._init_stats()

    def _init_stats(self):
        self.per_species: dict[str, dict] = {
            sp: {
                "count": _RunningStats(),
                "area": _RunningStats(),
                "tilt": _RunningStats(),
                "mean_curv": _RunningStats(),
                "gauss_curv": _RunningStats(),
                "n_neighbors": _RunningStats(),
                "order": None,  # lazily sized per tail
                "neib_fractions": {s: _RunningStats() for s in self.species_names},
            }
            for sp in self.species_names
        }

    def frame_update(self, lipids) -> None:
        """Fold one frame of the host pipeline in: ``lipids`` are the host
        ``Membrane``'s ``LipidMolecule`` objects, indexed by lipid id."""
        by_species: dict[str, list] = {s: [] for s in self.species_names}
        in_group = set(self.lipid_ids)
        for lid in self.lipid_ids:
            lip = lipids[lid]
            if lip.valid:
                by_species[lip.species.name].append(lip)
        for sp, lips in by_species.items():
            st = self.per_species[sp]
            st["count"].add(len(lips))
            if not lips:
                continue
            st["area"].add(np.mean([l.area for l in lips]))
            tilts = []
            for l in lips:
                cosang = np.clip(
                    l.normal
                    @ l.tail_head_vec
                    / (np.linalg.norm(l.normal) * np.linalg.norm(l.tail_head_vec)),
                    -1,
                    1,
                )
                tilts.append(np.degrees(np.arccos(cosang)))
            st["tilt"].add(np.mean(tilts))
            st["mean_curv"].add(np.mean([l.mean_curv for l in lips]))
            st["gauss_curv"].add(np.mean([l.gaussian_curv for l in lips]))
            st["n_neighbors"].add(np.mean([len(l.neib_ids) for l in lips]))
            # neighbor species fractions
            fracs = {s: 0.0 for s in self.species_names}
            total = 0
            for l in lips:
                for nid in l.neib_ids:
                    if nid in in_group:
                        fracs[lipids[nid].species.name] = (
                            fracs.get(lipids[nid].species.name, 0.0) + 1
                        )
                        total += 1
            if total:
                for s in self.species_names:
                    st["neib_fractions"][s].add(fracs.get(s, 0.0) / total)
            # order profiles averaged per tail position
            if lips[0].order:
                if st["order"] is None:
                    st["order"] = [
                        _RunningStats(o.shape) for o in lips[0].order
                    ]
                for k in range(len(lips[0].order)):
                    st["order"][k].add(
                        np.mean([l.order[k] for l in lips], axis=0)
                    )

    def save(self, outdir: str) -> None:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"stats_{self.name}.dat")
        with open(path, "w") as fh:
            fh.write(
                "# species count area tilt_deg mean_curv gauss_curv n_neighbors (mean +- std)\n"
            )
            for sp in self.species_names:
                st = self.per_species[sp]
                fh.write(
                    f"{sp} "
                    f"{st['count'].mean:.3f}±{st['count'].std:.3f} "
                    f"{st['area'].mean:.4f}±{st['area'].std:.4f} "
                    f"{st['tilt'].mean:.2f}±{st['tilt'].std:.2f} "
                    f"{st['mean_curv'].mean:.4f}±{st['mean_curv'].std:.4f} "
                    f"{st['gauss_curv'].mean:.4f}±{st['gauss_curv'].std:.4f} "
                    f"{st['n_neighbors'].mean:.2f}±{st['n_neighbors'].std:.2f}\n"
                )
        for sp in self.species_names:
            st = self.per_species[sp]
            if st["order"] is None:
                continue
            opath = os.path.join(outdir, f"order_{self.name}_{sp}.dat")
            with open(opath, "w") as fh:
                fh.write("# carbon tail order (mean +- std) per tail\n")
                for k, acc in enumerate(st["order"]):
                    fh.write(f"# tail {k}\n")
                    for i, (m, s) in enumerate(zip(acc.mean, acc.std)):
                        fh.write(f"{i + 2} {m:.4f} {s:.4f}\n")


def merge_groups(groups: dict, others: dict) -> None:
    """Fold the group statistics ``others`` (name -> :class:`LipidGroup`)
    into ``groups`` (Chan et al. per accumulator): exact up to float
    rounding and in any order. Groups and species must match."""
    if set(groups) != set(others):
        raise MembraneError("cannot merge: group names differ")
    for name, gr in groups.items():
        ogr = others[name]
        if gr.species_names != ogr.species_names:
            raise MembraneError(f"cannot merge group {name!r}: species differ")
        for sp in gr.species_names:
            st, ost = gr.per_species[sp], ogr.per_species[sp]
            for key in ("count", "area", "tilt", "mean_curv", "gauss_curv", "n_neighbors"):
                st[key].merge(ost[key])
            for s, acc in ost["neib_fractions"].items():
                st["neib_fractions"][s].merge(acc)
            if ost["order"] is not None:
                if st["order"] is None:
                    st["order"] = [_RunningStats(o.mean.shape) for o in ost["order"]]
                for mine, theirs in zip(st["order"], ost["order"]):
                    mine.merge(theirs)


def _tilt_deg(normals, thv):
    num = np.sum(normals * thv, axis=1)
    den = np.linalg.norm(normals, axis=1) * np.linalg.norm(thv, axis=1)
    c = np.clip(num / np.where(den == 0, 1.0, den), -1, 1)
    return np.degrees(np.arccos(c))
