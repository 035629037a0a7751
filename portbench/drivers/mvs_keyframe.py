"""Driver of the multi-view keyframe cells: closed-loop keyframe cycles
through the program's ``apps.stereo.MultiViewStereo``. A cycle is
``reset`` with the keyframe's rectified pair (the seed volume), ``add`` of
each posed view, each synchronised as a live camera's frame would be, and
one ``solve()`` (the DTAM solve).

Traffic parameters: ``views`` (the frames a handheld camera takes after the
keyframe, each posed, see ``data.synthetic.handheld_track``), ``pool``
(distinct scenes and tracks, made from seeds seed .. seed + pool - 1 and
cycled) and ``trace_units`` (cycles traced in a ``--trace 1`` run).

The cell's checks: ``sample_stride`` and ``sample_count`` (which cycles keep
their volume and disparity, see ``compare.Sample``), the tolerances and the
limits. Each kept cycle's ``volume()`` and solved disparity are compared
with the plain reference (``reference/mvs.py``) on the same scene.
``volume_mismatch`` is the largest share, over the kept cycles, of cells
that differ by more than ``tolerance_cost``; ``disp_mismatch`` the largest
share of pixels that differ by more than ``tolerance_px``.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import compare
from portbench.data import synthetic
from portbench.reference import mvs as reference


class Driver:
    def __init__(self, config: dict, traffic: dict, check: dict, seed: int,
                 device: torch.device):
        from kangaroo_tpu_torch.apps import stereo
        from kangaroo_tpu_torch.containers import Intrinsics

        W, H = config["width"], config["height"]
        self.cfg_dict = config["stereo"]
        self.rad, self.baseline = config["rad"], config["baseline"]
        K = Intrinsics.centered(config["focal"], W, H)
        self.K = {"fu": K.fu, "fv": K.fv, "u0": K.u0, "v0": K.v0}
        self.mvs = stereo.MultiViewStereo(K, self.baseline, stereo.StereoConfig(**self.cfg_dict),
                                          rad=self.rad)
        self.views, self.pool = traffic["views"], traffic["pool"]
        self.tol_px, self.tol_cost = check["tolerance_px"], check["tolerance_cost"]
        self.frames_per_unit = self.views
        D = self.cfg_dict["max_disp"]
        scenes = [synthetic.handheld_track(W, H, D, self.K, self.baseline, self.views, seed + j,
                                           device) for j in range(self.pool)]
        self.keys, self.rights, self.imgs = (torch.stack([s[i] for s in scenes]) for i in range(3))
        self.poses_np = [s[3] for s in scenes]
        self.poses = torch.from_numpy(np.stack(self.poses_np)).to(device)
        self.identity = torch.eye(3, 4, dtype=torch.float32, device=device)
        self.sample = compare.Sample(check["sample_stride"], check["sample_count"])
        self.clock = compare.Clock(device)
        self.kept: dict[int, tuple] = {}  # unit -> (volume, disparity)
        self.refs: dict[int, tuple] = {}  # scene -> reference (volume, disparity)

    def _cycle(self, j: int) -> tuple[torch.Tensor, list[float]]:
        lat = []
        with torch.profiler.record_function("portbench:reset"):
            self.mvs.reset(self.keys[j], self.identity, right=self.rights[j])
        for v in range(self.views):
            t = self.clock.start()
            with torch.profiler.record_function("portbench:add"):
                self.mvs.add(self.imgs[j, v], self.poses[j, v])
            lat.append(self.clock.stop_ms(t))
        with torch.profiler.record_function("portbench:solve"):
            disp = self.mvs.solve()
        if disp.is_cuda:
            torch.cuda.synchronize()
        return disp, lat

    def warmup(self) -> None:
        self._cycle(0)

    def run_unit(self, unit: int) -> list[float]:
        """One keyframe cycle; the latency of each view's ``add``."""
        disp, lat = self._cycle(unit % self.pool)
        if self.sample.keeps(unit):
            self.kept[unit] = (self.mvs.volume(), disp)
        return lat

    def free(self) -> None:
        self.mvs = None

    def _reference(self, j: int, dtype=torch.float32) -> tuple:
        if dtype == torch.float32 and j in self.refs:
            return self.refs[j]
        poses = self.poses_np[j]
        out = reference.keyframe(self.keys[j], self.rights[j],
                                 [(self.imgs[j, v], poses[v]) for v in range(self.views)],
                                 self.K, self.baseline, self.cfg_dict, self.rad, dtype)
        if dtype == torch.float32:
            self.refs[j] = out
        return out

    def _compare(self, answers: dict, limits: dict) -> tuple[dict, int, int]:
        vols, disps = [], []
        for unit, (vol, disp) in sorted(answers.items()):
            ref_vol, ref_disp = self._reference(unit % self.pool)
            vols.append(compare.mismatch_share(vol[None], ref_vol[None], self.tol_cost))
            disps.append(compare.mismatch_share(disp[None], ref_disp[None], self.tol_px))
        if not vols:
            return {"volume_mismatch": float("nan"), "disp_mismatch": float("nan")}, 0, 0
        vol, disp = torch.cat(vols), torch.cat(disps)
        bad = (vol > limits["volume_mismatch"]) | (disp > limits["disp_mismatch"])
        return ({"volume_mismatch": float(vol.max()), "disp_mismatch": float(disp.max())},
                len(vol) * self.views, int(bad.sum()) * self.views)

    def check(self, limits: dict) -> tuple[dict, int, int]:
        """(numbers compared, frames compared, frames over a limit) of the
        kept cycles: a cycle's views stand or fall with its keyframe."""
        return self._compare(self.kept, limits)

    def control(self, limits: dict) -> tuple[dict, int, int]:
        """``check`` with the reference's costs in bfloat16 in the program's
        place."""
        answers = {u: self._reference(u % self.pool, torch.bfloat16) for u in self.kept}
        return self._compare(answers, limits)
