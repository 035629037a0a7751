"""Driver of the SGM cells: stacks of rectified pairs through the program's
``apps.stereo_sgm.sgm_pipeline_batched`` (``sgm_pipeline`` for a batch of
one), closed loop, back to back.

Traffic parameters: ``batch`` (pairs a call), ``pool`` (distinct pairs,
made from seeds seed .. seed + pool - 1 and cycled, a multiple of
``batch``) and ``trace_units`` (calls traced in a ``--trace 1`` run).

The cell's checks: ``sample_stride`` and ``sample_count`` (which calls keep
their disparities, see ``compare.Sample``), the tolerance and the limit.
Each kept call's disparities against the plain reference
(``reference/sgm.py``) on the same pairs. ``disp_mismatch`` is the largest
share, over the kept frames, of pixels where the two are not both invalid
and differ by more than ``tolerance_px``.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import compare
from portbench.data import synthetic
from portbench.reference import sgm as reference


class Driver:
    def __init__(self, config: dict, traffic: dict, check: dict, seed: int,
                 device: torch.device):
        from kangaroo_tpu_torch.apps import stereo_sgm

        self.app = stereo_sgm
        self.cfg_dict = config["sgm"]
        self.cfg = stereo_sgm.SgmConfig(**self.cfg_dict)
        self.batch, self.pool = traffic["batch"], traffic["pool"]
        if self.pool % self.batch:
            raise ValueError(f"pool {self.pool} is not a multiple of the batch {self.batch}")
        self.tol = check["tolerance_px"]
        self.frames_per_unit = self.batch
        W, H, D = config["width"], config["height"], self.cfg.max_disp
        pairs = [synthetic.stereo_pair(W, H, D, seed + j)[:2] for j in range(self.pool)]
        self.lefts = torch.from_numpy(np.stack([p[0] for p in pairs])).to(device)
        self.rights = torch.from_numpy(np.stack([p[1] for p in pairs])).to(device)
        self.sample = compare.Sample(check["sample_stride"], check["sample_count"])
        self.clock = compare.Clock(device)
        self.kept: dict[int, torch.Tensor] = {}  # unit -> disparities
        self.refs: dict[int, torch.Tensor] = {}  # first pair -> reference disparities

    def _slice(self, unit: int) -> slice:
        start = (unit * self.batch) % self.pool
        return slice(start, start + self.batch)

    def _call(self, sl: slice) -> torch.Tensor:
        if self.batch == 1:
            return self.app.sgm_pipeline(self.lefts[sl.start], self.rights[sl.start],
                                         self.cfg)[None]
        return self.app.sgm_pipeline_batched(self.lefts[sl], self.rights[sl], self.cfg)

    def warmup(self) -> None:
        self._call(self._slice(0))

    def run_unit(self, unit: int) -> list[float]:
        """One call, synchronised; each of its frames has the call's
        latency."""
        t = self.clock.start()
        with torch.profiler.record_function("portbench:batch"):
            disp = self._call(self._slice(unit))
        ms = self.clock.stop_ms(t)
        if self.sample.keeps(unit):
            self.kept[unit] = disp
        return [ms] * self.batch

    def free(self) -> None:
        """The frame keeps no state between calls."""

    def _reference(self, sl: slice, dtype=torch.float32) -> torch.Tensor:
        if dtype != torch.float32:
            return reference.frames(self.lefts[sl], self.rights[sl], self.cfg_dict, dtype)
        if sl.start not in self.refs:
            self.refs[sl.start] = reference.frames(self.lefts[sl], self.rights[sl],
                                                   self.cfg_dict)
        return self.refs[sl.start]

    def _compare(self, answers: dict, limits: dict) -> tuple[dict, int, int]:
        shares = [compare.mismatch_share(disp, self._reference(self._slice(unit)), self.tol)
                  for unit, disp in sorted(answers.items())]
        if not shares:
            return {"disp_mismatch": float("nan")}, 0, 0
        share = torch.cat(shares)
        return ({"disp_mismatch": float(share.max())}, len(share),
                int((share > limits["disp_mismatch"]).sum()))

    def check(self, limits: dict) -> tuple[dict, int, int]:
        """(numbers compared, frames compared, frames over a limit) of the
        kept calls."""
        return self._compare(self.kept, limits)

    def control(self, limits: dict) -> tuple[dict, int, int]:
        """``check`` with the reference in bfloat16 in the program's place."""
        answers = {u: self._reference(self._slice(u), torch.bfloat16) for u in self.kept}
        return self._compare(answers, limits)
