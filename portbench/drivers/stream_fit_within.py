"""Traffic of the trajectory stream: per frame, the mass-weighted fit and RMSD
of the protein against its starting coordinates and a periodic ``within``
of every atom against the protein, through the port's main path
(``run_with_overflow_retry`` -> ``WindowPipeline`` ->
``headline.FitWithinWindow``, built by ``convert.from_numpy``, windowed by
``auto_window``), as ``headline.run`` drives it.

The seeded XTC is streamed as one stream over the file repeated until the
measured time is up. ``correct`` compares, on the file frames drawn from
the seed, every frame of the window that holds one: its RMSD against the
float64 reference, and its within set, by the program's count and
membership checksum, against the reference's set.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..frozen import codec, systems
from ..harness import work
from ..harness.checks import Check, digest, digest_matches, sample
from ..reference import geometry
from .common import MAX_PASSES, LayerRun, Window, deadline_reader, device_ms, memo, pipelines, \
    sync, tf32, warm_ranges, write_trajectory


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.xtc = str(workdir / "traj.xtc")
        self.cutoff = float(traffic["cutoff_nm"])

    # ---------------------------------------------------------------- inputs

    def inputs(self) -> None:
        """The system and its trajectory from the seed (no program code)."""
        s = systems.build(self.config)
        self.box = s["box"]
        self.pidx = s["protein"]
        self.ref = s["coords"][self.pidx]
        self.masses = s["masses"][self.pidx]
        tr = self.config["trajectory"]
        self.n_file = int(tr["frames"])
        write_trajectory(self.xtc, self.config, s, self.seed)

    # --------------------------------------------------------------- program

    def setup(self) -> None:
        from molar_tpu_torch import convert, headline
        from molar_tpu_torch.core.pbc import PeriodicBox
        from molar_tpu_torch.ops.neighbor import grid_dims_for
        from molar_tpu_torch.tasks.trajectory import auto_window

        self.inputs()
        box = PeriodicBox(self.box)
        dims = grid_dims_for(box, self.cutoff)
        caps0 = headline.base_caps(self.xtc, box.inv, dims, self.pidx)
        w = self.traffic["window"]
        self.window_frames = auto_window(self.xtc) if w == "auto" else int(w)

        def build(tier):
            return convert.from_numpy(self.ref, self.masses, self.pidx, box.matrix, self.cutoff,
                                      headline.caps_for(*caps0, tier), dims, self.device,
                                      search=self.traffic["route"])

        self.build = build
        for first, last in warm_ranges(self.n_file, self.window_frames):
            self._stream([self.xtc], None, first, last)

    def _stream(self, paths, deadline, begin=None, end=None, max_windows=None):
        from molar_tpu_torch.tasks import trajectory

        reader = deadline_reader(paths, deadline, begin, end, max_windows)
        with pipelines() as made:
            results, retried = trajectory.run_with_overflow_retry(
                reader, self.window_frames, self.build, self.device, overflow_of=lambda r: r[3],
                n_tiers=int(self.traffic["overflow_tiers"]), quantized=trajectory.WIRE)
            ids = np.concatenate([np.asarray(i) for i, _ in results])
            cols = [torch.cat([r[k] for _, r in results]).cpu().numpy() for k in range(3)]
        return ids, cols, retried, reader, made[0]

    def window(self, seconds: float, traced: bool = False) -> Window:
        """The timed stream; in a traced run it ends after the traffic's
        ``trace_windows`` windows where the traffic names them (the profiler's
        events of a longer stretch take too long to read)."""
        windows = self.traffic.get("trace_windows") if traced else None
        t0 = time.perf_counter()
        ids, (rmsd, count, check), retried, reader, pipe = self._stream(
            [self.xtc] * MAX_PASSES, t0 + seconds, max_windows=windows)
        self.window_s = time.perf_counter() - t0
        self.ids, self.rmsd, self.count, self.check_sum = ids, rmsd, count, check
        self.retried = retried
        self.spans = {**reader.timings, **{k: v for k, v in pipe.timings.items()
                                          if k not in ("decode", "pack")}}
        return Window({"fps": len(ids) / self.window_s}, attempted=len(ids),
                      notes=[f"windows of {self.window_frames} frames: {len(ids)} frames, "
                             f"{len(ids) / self.n_file:.2f} passes of the file, "
                             f"{retried} retried"])

    # ------------------------------------------------------------ per layer

    def layer_run(self) -> LayerRun:
        from molar_tpu_torch.convert import transport_to_torch
        from molar_tpu_torch.ops.measure import fit_rmsd
        from molar_tpu_torch.tasks import trajectory

        model = self.build(0)
        first = next(trajectory.TrajectoryReader([self.xtc]).iter_windows(
            self.window_frames, quantized=trajectory.WIRE))
        transport, boxes, invs = transport_to_torch(first, self.device)
        coords = trajectory.decode_window_coords(transport)
        with codec.XtcFile(self.xtc) as f:
            frames = np.stack([f.frame(int(i))[0] for i in first[4]])

        def fit():
            ms = device_ms(lambda: fit_rmsd(coords[:, model.protein_idx], model.ref,
                                            model.masses), self.device)
            return ms / len(frames), None

        def search():
            ms = device_ms(lambda: model.masks(coords, boxes, invs), self.device)
            return ms, work.search_work(frames, self.box, self.pidx, self.cutoff)

        return LayerRun(frames=len(self.ids), window_s=self.window_s, spans=dict(self.spans),
                        parts={"fit": memo(fit), "search": memo(search)})

    def release(self) -> None:
        self.build = None
        sync(self.device)

    # ------------------------------------------------------------ correctness

    def reference(self, frames, dtype=torch.float64) -> dict:
        """file frame -> (rmsd, within set, undecidable band) by the plain
        reference in ``dtype`` on the run's device."""
        band = float(self.traffic["check"]["band_nm"])
        out = {}
        ref = torch.as_tensor(self.ref, dtype=dtype, device=self.device)
        masses = torch.as_tensor(self.masses, dtype=dtype, device=self.device)
        with codec.XtcFile(self.xtc) as f:
            for fr in frames:
                x = torch.as_tensor(f.frame(int(fr))[0], dtype=dtype, device=self.device)
                rmsd = float(geometry.fit_rmsd(x[self.pidx], ref, masses)[0])
                dmin = geometry.min_distance(x, self.pidx, self.box, self.cutoff + 0.1)
                sure, unsure = geometry.within_sets(dmin.cpu().numpy(), self.cutoff, band)
                out[int(fr)] = (rmsd, sure, unsure)
        return out

    def compare(self, answers: dict, want: dict) -> list[Check]:
        """``answers``: file frame -> list of (rmsd, count, checksum), one a
        time the window produced the frame."""
        limits = self.traffic["check"]["limits"]
        worst, wrong, n = 0.0, 0, 0
        for fr, got in answers.items():
            rmsd, sure, unsure = want[fr]
            for r, c, s in got:
                n += 1
                worst = max(worst, abs(float(r) - rmsd))
                wrong += not digest_matches(int(c), int(s), sure, unsure)
        return [Check("rmsd_err_nm", worst, limits["rmsd_err_nm"]),
                Check("within_frames_wrong", wrong, limits["within_frames_wrong"]),
                Check("frames_compared_missing", 0 if n else 1, 0)]

    def check(self) -> list[Check]:
        frames = sample(self.seed, self.n_file, int(self.traffic["check"]["frames"]))
        order_ok = np.array_equal(self.ids, np.arange(len(self.ids)))
        file_fr = self.ids % self.n_file
        answers = {int(fr): [(self.rmsd[k], self.count[k], self.check_sum[k])
                             for k in np.flatnonzero(file_fr == fr)] for fr in frames}
        answers = {fr: a for fr, a in answers.items() if a}
        checks = self.compare(answers, self.reference(sorted(answers)))
        return checks + [Check("frames_out_of_order", 0 if order_ok else 1, 0)]

    def control(self) -> list[Check]:
        """The reference in TF32 (float32 products on the tensor cores) put
        in the program's place, on the same sampled frames."""
        frames = sample(self.seed, self.n_file, int(self.traffic["check"]["frames"]))
        with tf32():
            low = self.reference(frames, torch.float32)
        answers = {fr: [(r, *digest(sure))] for fr, (r, sure, _) in low.items()}
        return self.compare(answers, self.reference(frames))
