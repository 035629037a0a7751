"""The WTA + subpixel kernel (``csrc/wta.cu``) and its Python wrapper.

Counterpart of ``kangaroo_tpu/stereo/wta_pallas.py`` (``_wta_kernel``,
``cost_vol_minimum_subpix``). The plain version is
``stereo/costvolume.cost_vol_minimum_subpix``.
"""
from __future__ import annotations

import torch

from .. import _build, backend

# kernel launches since the last reset
launches = 0


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
        rc = lib.kt_wta_subpix(vol.data_ptr(), int(vol.dtype == torch.bfloat16),
                               out.data_ptr(), D, H, W, int(sd), backend.stream_handle(vol))
        backend.check_launch(rc, "wta")
        launches += 1
    return out
