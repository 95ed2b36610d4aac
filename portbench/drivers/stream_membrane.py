"""Traffic of the lipid-membrane analysis: per frame, each lipid's patch,
normal, quadric fit, curvatures, Voronoi area and tail order parameters,
folded into the ``upper`` and ``lower`` leaflets' statistics, through the
path ``molar-torch membrane`` runs on the card (``cli.cmd_membrane``):
``System.from_file`` of the GRO, ``Membrane(system, <TOML>)``,
``split_leaflets``, then ``workloads.stream_membrane(MembraneDevice(
membrane, device=...), reader, MEMBRANE_WINDOW)``, whose every window's
outputs come back to the host and are folded in before the next is read.

The seeded XTC is streamed as one stream over the file repeated until the
measured time is up. ``correct`` compares against the float64 reference
(``reference/membrane.py``):

* per lipid, on the file frames drawn from the seed, every time the stream
  produced one: validity, area, mean curvature and order parameters, over
  the lipids that float32 arithmetic can decide (a head pair within
  ``band_nm`` of the cutoff, in the lipid's patch or a member's, or a fit
  whose ``|f|`` lies within it of 0.5, makes a lipid undecidable; those
  are counted);
* the fold, on one window of the timed stream drawn from the seed: what
  the program's own group statistics (each leaflet's Welford streams of
  valid lipids, area, tilt, both curvatures, Voronoi neighbours, neighbour
  species fractions and order profiles) gained over that window, against
  the same statistics of the reference's results on the window's frames,
  with the reference's own leaflets;
* and that every frame of the stream was folded into both leaflets.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..frozen import codec, systems
from ..harness import bilayer, membrane_work
from ..harness.checks import Check, sample
from ..reference import membrane as ref_membrane
from .common import MAX_PASSES, LayerRun, Window, deadline_reader, device_ms, memo, pipelines, \
    seeded_order, sync, warm_ranges

#: The program's per-lipid outputs the comparison reads.
_COMPARED = ("valid", "area", "mean_curv")
#: The group statistics compared after the fold, each with its check's name
#: (the ``neib_fraction.<species>`` and ``order.<tail>`` streams are named
#: by their prefix).
_FOLDED = {"count": "group_count_err", "area": "group_area_err_nm2",
           "tilt": "group_tilt_err_deg", "mean_curv": "group_mean_curv_err_per_nm",
           "gauss_curv": "group_gauss_curv_err_per_nm2",
           "n_neighbors": "group_neighbors_err", "neib_fraction": "group_neib_fraction_err",
           "order": "group_order_err"}


def _tail(text: str):
    """A TOML tail string ``C1-C2=C3...`` -> (carbon names, bond orders)."""
    names, orders, cur = [], [], ""
    for ch in text:
        if ch in "-=":
            names.append(cur)
            orders.append(1 if ch == "-" else 2)
            cur = ""
        else:
            cur += ch
    return names + [cur], tuple(orders)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.gro = str(workdir / "conf.gro")
        self.xtc = str(workdir / "traj.xtc")
        self.toml = str(workdir / "membrane.toml")
        self.output_dir = str(workdir / "membrane")
        self.analysis = config["analysis"]
        self.cutoff = float(self.analysis["cutoff_nm"])

    # ---------------------------------------------------------------- inputs

    def inputs(self) -> None:
        """The bilayer, its GRO, the membrane TOML and the trajectory from
        the seed (no program code)."""
        s = bilayer.build(self.config)
        self.box = s["box"]
        n_atoms = len(s["coords"])
        systems.write_gro(self.gro, s["labels"], s["coords"], s["box"],
                          f"{self.config['name']} (portbench)")
        an = self.analysis
        with open(self.toml, "w") as fh:
            fh.write(f"cutoff = {self.cutoff}\norder_type = {json.dumps(an['order_type'])}\n"
                     f"groups = {json.dumps(an['groups'])}\n"
                     f"output_dir = {json.dumps(self.output_dir)}\n\n"
                     f"[lipids.{an['species']}]\nwhole = {json.dumps(an['whole'])}\n"
                     f"head = {json.dumps(an['head'])}\nmid = {json.dumps(an['mid'])}\n"
                     f"tails = {json.dumps(an['tails'])}\n")
        tr = self.config["trajectory"]
        self.n_file = int(tr["frames"])
        codec.write_walk(self.xtc, s["coords"], s["box"], self.n_file, float(tr["sigma_nm"]),
                         seed=int(self.config["structure_seed"]) + 1,
                         precision=float(tr["xtc_precision"]), held=np.arange(n_atoms),
                         held_rms=float(tr["held_rms_nm"]),
                         order=seeded_order(self.seed, self.n_file))
        # The reference's view of the lipids: rows, markers and tails by name.
        names = bilayer.NAMES
        n_lipids = n_atoms // len(names)

        def offsets(selection: str):
            kind, name = selection.split()
            if kind != "name":
                raise ValueError(f"the reference reads marker selections 'name X', not "
                                 f"{selection!r}")
            return [names.index(name)]

        carbon_tails = [_tail(t) for t in an["tails"]]
        self.lipids = ref_membrane.Lipids(
            rows=torch.arange(n_atoms, device=self.device).reshape(n_lipids, len(names)),
            masses=torch.as_tensor(s["masses"][:len(names)]),
            head=offsets(an["head"]),
            tail_end=[names.index(c[-1]) for c, _ in carbon_tails],
            tails=[([names.index(c) for c in carbons], orders)
                   for carbons, orders in carbon_tails])
        self.order_values = sum(len(c) - 2 for c, _ in carbon_tails)

    # --------------------------------------------------------------- program

    def setup(self) -> None:
        from molar_tpu_torch.core.system import System
        from molar_tpu_torch.membrane import Membrane, MembraneDevice, split_leaflets
        from molar_tpu_torch.workloads import MEMBRANE_WINDOW

        self.inputs()
        system = System.from_file(self.gro, device=self.device)
        with open(self.toml) as fh:
            self.membrane = Membrane(system, fh.read())
        split_leaflets(self.membrane)
        self.groups = {name: np.isin(np.arange(len(self.membrane.lipids)), gr.lipid_ids)
                       for name, gr in self.membrane.groups.items()}
        self.dev = MembraneDevice(self.membrane, device=self.device)
        self.window_frames = self._window_frames()
        for first, last in warm_ranges(self.n_file, self.window_frames):
            self._stream([self.xtc], None, first, last)

    def _window_frames(self) -> int:
        w = self.traffic["window"]
        if w != "auto":
            return int(w)
        from molar_tpu_torch.workloads import MEMBRANE_WINDOW

        return MEMBRANE_WINDOW

    def _fold_window(self, n_windows: int) -> int:
        """The window whose fold is compared, drawn from the seed."""
        return int(np.random.default_rng([self.seed % (1 << 63), 0xF01D]).integers(n_windows))

    def _folded(self) -> dict:
        """Frames folded so far into each group's statistics."""
        sp = self.analysis["species"]
        return {name: gr.per_species[sp]["count"].n
                for name, gr in self.membrane.groups.items()}

    def _fold_sums(self) -> dict:
        """(group, statistic) -> (values added, their sum), read from each
        group's Welford streams of the species."""
        sp = self.analysis["species"]
        out = {}
        for name, gr in self.membrane.groups.items():
            st = gr.per_species[sp]
            streams = {k: st[k] for k in ("count", "area", "tilt", "mean_curv", "gauss_curv",
                                          "n_neighbors")}
            streams.update({f"neib_fraction.{s}": acc for s, acc in st["neib_fractions"].items()})
            streams.update({f"order.{k}": acc for k, acc in enumerate(st["order"] or [])})
            for key, acc in streams.items():
                out[(name, key)] = (acc.n, acc.n * np.asarray(acc.mean, np.float64))
        return out

    def _stream(self, paths, deadline, begin=None, end=None, max_windows=None):
        """The program's stream; each group's sums are read after every
        window's fold (the program's ``accumulate``, wrapped for the
        stream) -> (frames, outputs, reader, pipeline, the sums before the
        stream and after each fold)."""
        from molar_tpu_torch.workloads import stream_membrane

        reader = deadline_reader(paths, deadline, begin, end, max_windows)
        sums = [self._fold_sums()]
        accumulate = self.dev.accumulate

        def accumulate_and_read(outs):
            accumulate(outs)
            sums.append(self._fold_sums())

        self.dev.accumulate = accumulate_and_read
        try:
            with pipelines() as made:
                frames, outs = stream_membrane(self.dev, reader, self.window_frames)
        finally:
            del self.dev.accumulate
        return frames, outs, reader, made[0], sums

    def window(self, seconds: float, traced: bool = False) -> Window:
        """The timed stream; in a traced run it ends after the traffic's
        ``trace_windows`` windows (the profiler's events of a longer stretch
        take too long to read)."""
        windows = self.traffic.get("trace_windows") if traced else None
        folded = self._folded()
        t0 = time.perf_counter()
        frames, outs, reader, pipe, sums = self._stream([self.xtc] * MAX_PASSES, t0 + seconds,
                                                        max_windows=windows)
        self.window_s = time.perf_counter() - t0
        self.frames = frames
        self.unfolded = max(abs(n - folded[name] - frames) for name, n in self._folded().items())
        # The sampled file frames' outputs, each time the stream produced one.
        wanted = set(int(f) for f in sample(self.seed, self.n_file,
                                            int(self.traffic["check"]["frames"])))
        self.answers, pos = {}, 0
        for out in outs:
            for b in range(out["valid"].shape[0]):
                fr = (pos + b) % self.n_file
                if fr in wanted:
                    got = {k: out[k][b].copy() for k in _COMPARED}
                    got["order"] = [t[b].copy() for t in out["order"][self.analysis["species"]]]
                    self.answers.setdefault(fr, []).append(got)
            pos += out["valid"].shape[0]
        self.fold, self.fold_frames = {}, []
        if len(outs) and len(sums) == len(outs) + 1:
            self.fold, self.fold_frames = self.fold_of(outs, sums, self._fold_window(len(outs)))
        del outs
        self.spans = {**reader.timings, **{k: v for k, v in pipe.timings.items()
                                          if k not in ("decode", "pack")}}
        valid = self.spans.get("membrane.valid_lipid_frames")
        share = "" if valid is None else \
            f", {valid / max(frames * self.dev.n_lipids, 1):.4f} of lipid-frames valid"
        return Window({"fps": frames / self.window_s}, attempted=frames,
                      notes=[f"windows of {self.window_frames} frames: {frames} frames, "
                             f"{frames / self.n_file:.2f} passes of the file, patch cap "
                             f"{self.dev.patch_cap}{share}"])

    def fold_of(self, outs, sums, j: int):
        """What the fold of the stream's window ``j`` added to the groups:
        ((group, statistic) -> (values added, their mean), the window's file
        frames)."""
        first = sum(out["valid"].shape[0] for out in outs[:j])
        frames = [(first + b) % self.n_file for b in range(outs[j]["valid"].shape[0])]
        fold = {}
        for key, (n, total) in sums[j + 1].items():
            n0, total0 = sums[j].get(key, (0, 0.0))
            if n > n0:
                fold[key] = (n - n0, (total - total0) / (n - n0))
        return fold, frames

    # ------------------------------------------------------------ per layer

    def layer_run(self) -> LayerRun:
        from molar_tpu_torch.convert import transport_to_torch
        from molar_tpu_torch.tasks import trajectory

        first = next(trajectory.TrajectoryReader([self.xtc]).iter_windows(
            self.window_frames, quantized=trajectory.WIRE, subset=self.dev.subset))
        win = transport_to_torch(first, self.device)
        fn = self.dev.window_fn

        def forward():
            ms = device_ms(lambda: fn(*win), self.device)
            coords = trajectory.decode_window_coords(win[0]).to(torch.float64)
            rows = self.lipids.rows[:, self.lipids.head[0]]
            sides = torch.as_tensor(np.diag(self.box).copy(), dtype=torch.float64,
                                    device=self.device)
            heads = coords[:, rows]
            read = set(self.lipids.head) | set(self.lipids.tail_end)
            for carbons, _ in self.lipids.tails:
                read |= set(carbons)
            return ms, membrane_work.window_work(heads, sides, self.cutoff, len(read),
                                                 self.order_values)

        notes = [f"{k}: {1e3 * v / max(self.frames, 1):.6g} ms a frame"
                 for k, v in sorted(self.spans.items())
                 if k.startswith("membrane.") and k.endswith("@device")]
        return LayerRun(frames=self.frames, window_s=self.window_s, spans=dict(self.spans),
                        parts={"membrane": memo(forward)}, notes=notes)

    def release(self) -> None:
        self.dev = None
        self.membrane = None
        sync(self.device)

    # ------------------------------------------------------------ correctness

    def reference(self, frames, dtype=torch.float64, tf32: bool = False) -> dict:
        """file frame -> the reference's per-lipid results in ``dtype`` (its
        products on TF32 operands where ``tf32``) on the run's device, with
        the leaflets that the membrane command's split (head marker above
        the median height: ``upper``) gives on the structure, frame 0."""
        check = self.traffic["check"]
        out = {}
        sides = torch.as_tensor(np.diag(self.box).copy(), dtype=dtype, device=self.device)
        with codec.XtcFile(self.xtc) as f:
            for fr in sorted({0, *frames}):
                x = torch.as_tensor(f.frame(int(fr))[0], dtype=dtype, device=self.device)
                r = ref_membrane.analyse(x, sides, self.lipids, self.cutoff,
                                         self.analysis["order_type"], float(check["band_nm"]),
                                         tf32=tf32)
                out[int(fr)] = {k: v.cpu().numpy() if torch.is_tensor(v) else
                                [t.cpu().numpy() for t in v] for k, v in r.items()}
        z = out[0]["heads"][:, 2]
        upper = z > np.median(z)
        for r in out.values():
            r["groups"] = {"upper": upper, "lower": ~upper}
        return out

    def compare(self, answers: dict, want: dict) -> list[Check]:
        """``answers``: file frame -> list of result dicts (``valid``,
        ``area``, ``mean_curv``, ``order``), one a time the stream produced
        the frame."""
        limits = self.traffic["check"]["limits"]
        err = dict.fromkeys(("area", "mean_curv", "order"), 0.0)
        wrong, undecidable, lipid_frames, n = 0, 0, 0, 0
        for fr, got in answers.items():
            ref = want[fr]
            sure = ~ref["undecidable"]
            for g in got:
                n += 1
                lipid_frames += len(sure)
                undecidable += int((~sure).sum())
                wrong += int((sure & (g["valid"] != ref["valid"])).sum())
                both = sure & g["valid"] & ref["valid"]
                if not both.any():
                    continue
                for key in ("area", "mean_curv"):
                    err[key] = max(err[key], float(np.abs(g[key] - ref[key])[both].max()))
                for t_got, t_ref in zip(g["order"], ref["order"]):
                    err["order"] = max(err["order"], float(np.abs(t_got - t_ref)[both].max()))
        return [Check("area_err_nm2", err["area"], limits["area_err_nm2"]),
                Check("mean_curv_err_per_nm", err["mean_curv"], limits["mean_curv_err_per_nm"]),
                Check("order_err", err["order"], limits["order_err"]),
                Check("valid_lipids_wrong", wrong, 0),
                Check("undecidable_share", undecidable / max(lipid_frames, 1),
                      limits["undecidable_share"]),
                Check("frames_compared_missing", 0 if n else 1, 0)]

    def group_values(self, r: dict) -> dict:
        """(group, statistic) -> what one frame's results ``r`` add to the
        group's stream (``LipidGroup.frame_update``: the means over the
        group's valid lipids; no entry where the frame adds none), with the
        leaflets in ``r["groups"]``."""
        species = self.analysis["species"]
        n, thv = r["normal"], r["thv"]
        den = np.linalg.norm(n, axis=1) * np.linalg.norm(thv, axis=1)
        cos = np.sum(n * thv, axis=1) / np.where(den == 0, 1.0, den)
        tilt = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
        out = {}
        for name, members in r["groups"].items():
            sel = members & r["valid"]
            out[(name, "count")] = float(sel.sum())
            if not sel.any():
                continue
            for key in ("area", "mean_curv", "gauss_curv", "n_neighbors"):
                out[(name, key)] = float(np.mean(r[key][sel]))
            out[(name, "tilt")] = float(np.mean(tilt[sel]))
            ids = r["nb_ids"][sel]
            ok = (ids >= 0) & members[np.maximum(ids, 0)]
            if ok.any():  # every neighbour is of the cell's one species
                out[(name, f"neib_fraction.{species}")] = 1.0
            for k, t in enumerate(r["order"]):
                out[(name, f"order.{k}")] = np.mean(t[sel], axis=0)
        return out

    def compare_fold(self, fold: dict, frames: list, want: dict) -> list[Check]:
        """``fold``: (group, statistic) -> (values added, their mean) over
        the window of file ``frames``, against the reference's
        :meth:`group_values` on those frames: the largest difference of
        each statistic's mean, and the streams added to another number of
        times than the reference's frames add (1 where no window was
        folded)."""
        limits = self.traffic["check"]["limits"]
        added = {}
        for fr in frames:
            for key, v in self.group_values(want[fr]).items():
                added.setdefault(key, []).append(v)
        err = dict.fromkeys(_FOLDED.values(), 0.0)
        wrong = 0 if frames else 1
        for key in set(added) | set(fold):
            n, mean = fold.get(key, (0, None))
            values = added.get(key, [])
            if n != len(values):
                wrong += 1
                continue
            name = _FOLDED[key[1].split(".")[0]]
            want_mean = np.mean(np.asarray(values, np.float64), axis=0)
            diff = np.max(np.abs(np.asarray(mean) - want_mean))
            err[name] = max(err[name], float(diff))
        return [Check(name, value, limits[name]) for name, value in err.items()] + \
            [Check("group_streams_wrong", wrong, 0)]

    def check(self) -> list[Check]:
        want = self.reference(sorted(set(self.answers) | set(self.fold_frames)))
        return (self.compare(self.answers, want)
                + self.compare_fold(self.fold, self.fold_frames, want)
                + [Check("frames_not_folded", self.unfolded, 0)])

    def control(self) -> list[Check]:
        """The reference in float32 with its products on TF32 operands (the
        rounding TF32 does, made in the reference: cuBLAS keeps these small
        products in full float32 even where TF32 is allowed) put in the
        program's place, on the same sampled frames, and its group
        statistics in the fold's place on a window of the file drawn from
        the seed."""
        frames = [int(f) for f in sample(self.seed, self.n_file,
                                         int(self.traffic["check"]["frames"]))]
        w = self._window_frames()
        j = self._fold_window(-(-self.n_file // w))
        fold_frames = list(range(j * w, min((j + 1) * w, self.n_file)))
        every = sorted(set(frames) | set(fold_frames))
        low = self.reference(every, torch.float32, tf32=True)
        want = self.reference(every)
        added = {}
        for fr in fold_frames:
            for key, v in self.group_values(low[fr]).items():
                added.setdefault(key, []).append(v)
        fold = {key: (len(v), np.mean(np.asarray(v, np.float64), axis=0))
                for key, v in added.items()}
        return (self.compare({fr: [low[fr]] for fr in frames}, want)
                + self.compare_fold(fold, fold_frames, want))
