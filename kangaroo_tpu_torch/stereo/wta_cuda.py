"""The WTA + subpixel kernel (``csrc/wta.cu``), the DTAM auxiliary-search
kernel (``csrc/wta_sq.cuh``) and their Python wrappers.

Counterparts of ``kangaroo_tpu/stereo/wta_pallas.py`` (``_wta_kernel``,
``cost_vol_minimum_subpix``; ``_wta_sq_kernel``,
``cost_vol_minimum_square_penalty_subpix``). The plain versions are the
functions of the same names in ``stereo/costvolume.py``.
"""
from __future__ import annotations

import torch

from .. import _build, backend

# kernel launches since the last reset: the WTA kernel, and the auxiliary
# search (here and once per iteration inside the DTAM alternation,
# stereo/dtam_cuda.py)
launches = 0
sq_launches = 0


def cost_vol_minimum_subpix(vol: torch.Tensor, sd: int = -1) -> torch.Tensor:
    """WTA disparity with the parabola step of a (D, H, W) float32 or
    bfloat16 volume on the card -> (H, W) float32."""
    global launches
    backend.require_kernels(vol, "wta")
    backend.check_tensor(vol, "vol", (torch.float32, torch.bfloat16), 3)
    D, H, W = vol.shape
    out = torch.empty((H, W), dtype=torch.float32, device=vol.device)
    lib = _build.library()
    with torch.cuda.device(vol.device):
        backend.launch(lib.kt_wta_subpix, vol.data_ptr(), int(vol.dtype == torch.bfloat16),
                       out.data_ptr(), D, H, W, int(sd), backend.stream_handle(vol), op="wta")
        launches += 1
    return out


def check_volume_and_plane(vol: torch.Tensor, plane: torch.Tensor, name: str, op: str) -> None:
    """A (D, H, W) float32/bfloat16 volume and an (H, W) float32 plane on
    the same card."""
    backend.require_kernels(vol, op)
    backend.check_tensor(vol, "vol", (torch.float32, torch.bfloat16), 3)
    backend.check_tensor(plane, name, (torch.float32,), 2)
    if plane.shape != vol.shape[1:] or plane.device != vol.device:
        raise ValueError(f"{op}: {name} {tuple(plane.shape)} on {plane.device} does not match "
                         f"vol {tuple(vol.shape)} on {vol.device}")


def _search(entry: str, vol: torch.Tensor, last_disp: torch.Tensor, lam, theta,
            sd: int) -> torch.Tensor:
    check_volume_and_plane(vol, last_disp, "last_disp", "wta_sq")
    D, H, W = vol.shape
    out = torch.empty((H, W), dtype=torch.float32, device=vol.device)
    lib = _build.library()
    with torch.cuda.device(vol.device):
        backend.launch(getattr(lib, entry), vol.data_ptr(), int(vol.dtype == torch.bfloat16),
                       last_disp.data_ptr(), out.data_ptr(), D, H, W, int(sd), float(lam),
                       float(theta), backend.stream_handle(vol), op="wta_sq")
    return out


def cost_vol_minimum_square_penalty_subpix(vol: torch.Tensor, last_disp: torch.Tensor, lam,
                                           theta, sd: int = -1) -> torch.Tensor:
    """The DTAM auxiliary search on the card (``kt_wta_sq``, a span of 4
    pixels a thread): vol (D, H, W) float32 or bfloat16, last_disp (H, W)
    float32 -> (H, W) float32. ``lam`` and ``theta`` are numbers or 0-dim
    tensors (read on the host)."""
    global sq_launches
    out = _search("kt_wta_sq", vol, last_disp, lam, theta, sd)
    sq_launches += 1
    return out


def _square_penalty_pixel(vol: torch.Tensor, last_disp: torch.Tensor, lam, theta,
                          sd: int = -1) -> torch.Tensor:
    """``cost_vol_minimum_square_penalty_subpix`` through ``kt_wta_sq_pixel``
    (the one-thread-per-pixel design it replaced): the yardstick that the
    card checks hold ``kt_wta_sq`` against. No path calls it and no count
    records it."""
    return _search("kt_wta_sq_pixel", vol, last_disp, lam, theta, sd)
