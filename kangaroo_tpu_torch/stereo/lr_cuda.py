"""The left-right check kernel (``csrc/lr_check.cu``) and its Python wrappers.

Counterpart of ``kangaroo_tpu/stereo/lr_pallas.py`` (``_lr_kernel``,
``left_right_check``). The plain versions are
``stereo/costvolume.left_right_check`` and ``left_right_check_pair`` with the
same ``max_disp``. One kernel runs both: a launch checks one direction, or
both directions of a frame in the reference's order (the pair).
"""
from __future__ import annotations

import torch

from .. import _build, backend

# the widest row the kernel takes: two rows of float32 in the 227 KB of
# shared memory a block can have (csrc/lr_check.cu)
MAX_WIDTH = 29056

# kernel launches since the last reset: one a call, one-way or pair
launches = 0


def _check_inputs(disp_l: torch.Tensor, disp_r: torch.Tensor) -> tuple[int, int]:
    backend.require_kernels(disp_l, "lr_check")
    backend.check_tensor(disp_l, "disp_l", (torch.float32,), 2)
    backend.check_tensor(disp_r, "disp_r", (torch.float32,), 2)
    if disp_r.shape != disp_l.shape or disp_r.device != disp_l.device:
        raise ValueError("disp_l and disp_r must have one shape and device")
    H, W = disp_l.shape
    if not (H >= 1 and 1 <= W <= MAX_WIDTH):
        raise ValueError(f"lr_check: rows of 1 to {MAX_WIDTH} pixels fit in shared memory, "
                         f"got shape {(H, W)}")
    return H, W


def _launch(disp_l, disp_r, out_l, out_r, sd, max_diff, max_disp):
    global launches
    H, W = disp_l.shape
    with torch.cuda.device(disp_l.device):
        backend.launch(_build.library().kt_lr_check, disp_l.data_ptr(), disp_r.data_ptr(),
                       out_l.data_ptr(), None if out_r is None else out_r.data_ptr(), H, W,
                       int(sd), float(max_diff), int(max_disp), backend.stream_handle(disp_l),
                       op="lr_check")
        launches += 1


def left_right_check(disp_l: torch.Tensor, disp_r: torch.Tensor, sd: int = -1,
                     max_diff: float = 1.0, max_disp: int = 192) -> torch.Tensor:
    """LR consistency of two (H, W) float32 disparity images on the card;
    NaN where rejected. Column offsets outside the TPU kernel's sweep
    ([-1, max_disp) for sd=-1, [-max_disp, 2) for sd=+1) are rejected."""
    _check_inputs(disp_l, disp_r)
    if sd not in (-1, 1):
        raise ValueError(f"lr_check: sd must be -1 or +1, got {sd}")
    out = torch.empty_like(disp_l)
    _launch(disp_l, disp_r, out, None, sd, max_diff, max_disp)
    return out


def left_right_check_pair(disp_l: torch.Tensor, disp_r: torch.Tensor, max_diff: float = 1.0,
                          max_disp: int = 192) -> tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a frame in one launch, in the reference's order:
    disp_r' = check(disp_r, disp_l, +1), then disp_l' = check(disp_l,
    disp_r', -1). Returns (disp_l', disp_r')."""
    _check_inputs(disp_l, disp_r)
    out_l, out_r = torch.empty_like(disp_l), torch.empty_like(disp_r)
    _launch(disp_l, disp_r, out_l, out_r, 0, max_diff, max_disp)
    return out_l, out_r


def _check_pixel(disp_l: torch.Tensor, disp_r: torch.Tensor, sd: int = -1,
                 max_diff: float = 1.0, max_disp: int = 192) -> torch.Tensor:
    """``left_right_check`` through ``kt_lr_check_pixel`` (the
    one-thread-per-pixel design the row kernel replaced): the yardstick
    that the card checks hold it against. No path calls it and no count
    records it."""
    H, W = _check_inputs(disp_l, disp_r)
    k_min, k_max = (-1, max_disp - 1) if sd < 0 else (-max_disp, 1)
    out = torch.empty_like(disp_l)
    with torch.cuda.device(disp_l.device):
        backend.launch(_build.library().kt_lr_check_pixel, disp_l.data_ptr(),
                       disp_r.data_ptr(), out.data_ptr(), H, W, int(sd), float(max_diff), k_min,
                       k_max, backend.stream_handle(disp_l), op="lr_check")
    return out
