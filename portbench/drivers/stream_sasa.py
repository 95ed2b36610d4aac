"""Traffic of the SASA time series: per frame, the exact Lee-Richards area of
every protein residue (``n_slices`` z-slices, radii = element vdW + probe),
through ``run_with_overflow_retry`` -> ``workloads.Sasa``, with windows
that ship the protein rows only.

The seeded XTC is streamed as one stream over the file repeated until the
measured time is up. ``correct`` compares, on the file frames drawn from the
seed, every frame of the window that holds one: each residue's area against
the float64 reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..frozen import codec, systems
from ..harness import work
from ..harness.checks import Check, sample
from ..reference import sasa as ref_sasa
from .common import MAX_PASSES, LayerRun, Window, deadline_reader, device_ms, memo, pipelines, \
    sync, tf32, warm_ranges, write_trajectory


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, workdir):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.xtc = str(workdir / "traj.xtc")
        self.n_slices = int(traffic["slices"])

    def inputs(self) -> None:
        s = systems.build(self.config)
        self.box = s["box"]
        self.pidx = s["protein"]
        self.coords0 = s["coords"][self.pidx]
        elements = [s["labels"]["elements"][i] for i in self.pidx]
        # The radii both sides get: vdW + probe, rounded to float32 once.
        self.radii = (systems.vdw_nm(elements).astype(np.float64)
                      + float(self.traffic["probe_nm"])).astype(np.float32)
        resid = s["labels"]["resid"][self.pidx]
        self.residue_of = np.unique(resid, return_inverse=True)[1].astype(np.int64)
        self.n_residues = int(self.residue_of.max()) + 1
        tr = self.config["trajectory"]
        self.n_file = int(tr["frames"])
        write_trajectory(self.xtc, self.config, s, self.seed)

    def setup(self) -> None:
        from molar_tpu_torch import workloads
        from molar_tpu_torch.ops.measure import contiguous_segments_dense
        from molar_tpu_torch.ops.neighbor import estimate_caps, grid_dims
        from molar_tpu_torch.ops.sasa_lr import neighbor_lists

        self.inputs()
        if np.count_nonzero(self.box - np.diag(np.diag(self.box))):
            raise ValueError("the SASA traffic takes an orthorhombic box (its grid is the "
                             "box's extents)")
        # As convert.workload_from_numpy builds the workload, with these radii.
        radii = self.radii.astype(np.float64)
        extents = np.diag(self.box).astype(np.float64)
        dims = grid_dims(extents, 2 * float(radii.max()))
        c0 = self.coords0.astype(np.float64)
        nb0, _ = neighbor_lists(c0, radii, cap=1024)
        cell0, _, _ = estimate_caps(c0, np.diag(1.0 / extents), dims, margin=1.0, round_to=1)
        idx, w, _ = contiguous_segments_dense(self.residue_of)
        self.model = workloads.Sasa(
            torch.as_tensor(self.radii), torch.as_tensor(idx.astype(np.int64)),
            torch.as_tensor(w), extents, dims, int((nb0 >= 0).sum(1).max()), int(cell0),
            n_slices=self.n_slices).to(self.device)
        w = self.traffic["window"]
        self.window_frames = workloads.SASA_WINDOW if w == "auto" else int(w)
        self.tiers = workloads.SASA_TIERS
        for first, last in warm_ranges(self.n_file, self.window_frames):
            self._stream([self.xtc], None, first, last)

    def _stream(self, paths, deadline, begin=None, end=None, max_windows=None):
        from molar_tpu_torch.tasks import trajectory

        reader = deadline_reader(paths, deadline, begin, end, max_windows)
        with pipelines() as made:
            results, retried = trajectory.run_with_overflow_retry(
                reader, self.window_frames, self.model.at_tier, self.device,
                overflow_of=lambda r: r[1], n_tiers=self.tiers, quantized=trajectory.WIRE,
                subset=self.pidx)
            ids = np.concatenate([np.asarray(i) for i, _ in results])
            areas = torch.cat([r[0] for _, r in results]).cpu().numpy()
        return ids, areas, retried, reader, made[0]

    def window(self, seconds: float, traced: bool = False) -> Window:
        """The timed stream; in a traced run it ends after the traffic's
        ``trace_windows`` windows where the traffic names them (the profiler's
        events of a longer stretch take too long to read)."""
        windows = self.traffic.get("trace_windows") if traced else None
        t0 = time.perf_counter()
        ids, areas, retried, reader, pipe = self._stream([self.xtc] * MAX_PASSES, t0 + seconds,
                                                            max_windows=windows)
        self.window_s = time.perf_counter() - t0
        self.ids, self.areas, self.retried = ids, areas, retried
        self.spans = {**reader.timings, **{k: v for k, v in pipe.timings.items()
                                          if k not in ("decode", "pack")}}
        return Window({"fps": len(ids) / self.window_s}, attempted=len(ids),
                      notes=[f"windows of {self.window_frames} frames: {len(ids)} frames, "
                             f"{len(ids) / self.n_file:.2f} passes of the file, "
                             f"{retried} retried"])

    def layer_run(self) -> LayerRun:
        from molar_tpu_torch.convert import transport_to_torch
        from molar_tpu_torch.tasks import trajectory

        first = next(trajectory.TrajectoryReader([self.xtc]).iter_windows(
            self.window_frames, quantized=trajectory.WIRE, subset=self.pidx))
        dev = transport_to_torch(first, self.device)
        coords = trajectory.decode_window_coords(dev[0])

        def forward():
            ms = device_ms(lambda: self.model(*dev), self.device)
            return ms, work.sasa_work(coords, torch.as_tensor(self.radii, device=self.device),
                                      self.n_slices, self.n_residues)

        return LayerRun(frames=len(self.ids), window_s=self.window_s, spans=dict(self.spans),
                        parts={"sasa": memo(forward)})

    def release(self) -> None:
        self.model = None
        sync(self.device)

    def reference(self, frames, dtype=torch.float64) -> dict:
        out = {}
        radii = torch.as_tensor(self.radii, dtype=dtype, device=self.device)
        res = torch.as_tensor(self.residue_of, device=self.device)
        with codec.XtcFile(self.xtc) as f:
            for fr in frames:
                x = torch.as_tensor(f.frame(int(fr))[0][self.pidx], dtype=dtype,
                                    device=self.device)
                out[int(fr)] = ref_sasa.residue_areas(x, radii, res, self.n_residues,
                                                      self.n_slices).cpu().numpy()
        return out

    def compare(self, answers: dict, want: dict) -> list[Check]:
        limits = self.traffic["check"]["limits"]
        worst, n = 0.0, 0
        for fr, got in answers.items():
            for a in got:
                n += 1
                worst = max(worst, float(np.abs(np.asarray(a, np.float64) - want[fr]).max()))
        return [Check("residue_area_err_nm2", worst, limits["residue_area_err_nm2"]),
                Check("frames_compared_missing", 0 if n else 1, 0)]

    def check(self) -> list[Check]:
        frames = sample(self.seed, self.n_file, int(self.traffic["check"]["frames"]))
        file_fr = self.ids % self.n_file
        answers = {int(fr): [self.areas[k] for k in np.flatnonzero(file_fr == fr)]
                   for fr in frames}
        answers = {fr: a for fr, a in answers.items() if a}
        order_ok = np.array_equal(self.ids, np.arange(len(self.ids)))
        return self.compare(answers, self.reference(sorted(answers))) + [
            Check("frames_out_of_order", 0 if order_ok else 1, 0)]

    def control(self) -> list[Check]:
        frames = sample(self.seed, self.n_file, int(self.traffic["check"]["frames"]))
        with tf32():
            low = self.reference(frames, torch.float32)
        return self.compare({fr: [a] for fr, a in low.items()}, self.reference(frames))
