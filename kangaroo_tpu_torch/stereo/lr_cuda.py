"""The left-right check kernel (``csrc/lr_check.cu``) and its Python wrapper.

Counterpart of ``kangaroo_tpu/stereo/lr_pallas.py`` (``_lr_kernel``,
``left_right_check``). The plain version is
``stereo/costvolume.left_right_check`` with the same ``max_disp``.
"""
from __future__ import annotations

import torch

from .. import _build, backend

# kernel launches since the last reset
launches = 0


def left_right_check(disp_l: torch.Tensor, disp_r: torch.Tensor, sd: int = -1,
                     max_diff: float = 1.0, max_disp: int = 192) -> torch.Tensor:
    """LR consistency of two (H, W) float32 disparity images on the card;
    NaN where rejected. Column offsets outside the TPU kernel's sweep
    ([-1, max_disp) for sd=-1, [-max_disp, 2) for sd=+1) are rejected."""
    global launches
    backend.require_kernels(disp_l, "lr_check")
    backend.check_tensor(disp_l, "disp_l", (torch.float32,), 2)
    backend.check_tensor(disp_r, "disp_r", (torch.float32,), 2)
    if disp_r.shape != disp_l.shape or disp_r.device != disp_l.device:
        raise ValueError("disp_l and disp_r must have one shape and device")
    H, W = disp_l.shape
    k_min, k_max = (-1, max_disp - 1) if sd < 0 else (-max_disp, 1)
    out = torch.empty_like(disp_l)
    lib = _build.library()
    with torch.cuda.device(disp_l.device):
        rc = lib.kt_lr_check(disp_l.data_ptr(), disp_r.data_ptr(), out.data_ptr(), H, W,
                             int(sd), float(max_diff), k_min, k_max,
                             backend.stream_handle(disp_l))
        backend.check_launch(rc, "lr_check")
        launches += 1
    return out
