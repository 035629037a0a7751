"""The running-mean view update (``csrc/cost_volume_add.cu``) and its wrapper.

No counterpart among the JAX package's Pallas kernels: ``kangaroo_tpu``
leaves ``cost_volume_add`` to XLA. The plain version is
``stereo/costvolume._cost_volume_add_plain``; the kernel computes the same
bits on the card in one launch a view (``stereo.costvolume.cost_volume_add``
routes a CUDA tensor here through ``dispatch._KernelOp``, whose backward is
the plain version's gradient).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, backend

# kernel launches since the last reset
launches = 0

# image dtypes the plain version casts to float32 exactly as the wrapper does
IMAGE_DTYPES = (torch.uint8, torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _f32(x) -> float:
    """``x`` rounded to float32, as ``backend.f32_scalars`` rounds it."""
    return ctypes.c_float(float(x)).value


def cost_volume_add(n: torch.Tensor, s: torch.Tensor, img_v: torch.Tensor, img_c: torch.Tensor,
                    KT_cv: torch.Tensor, K, baseline, rad: int = 1):
    """``cost_volume_add`` on the card: n, s (D, H, W) float32, contiguous;
    img_v, img_c (H, W) contiguous images (uint8 or floating, cast to
    float32); KT_cv (3, 4) floating, on the same card and read only there.
    Returns the new (n, s); the inputs are not modified."""
    global launches
    backend.require_kernels(n, "cost_volume_add")
    backend.check_tensor(n, "n", (torch.float32,), 3)
    backend.check_tensor(s, "s", (torch.float32,), 3)
    D, H, W = n.shape
    if s.shape != n.shape or s.device != n.device:
        raise ValueError(f"cost_volume_add: s {tuple(s.shape)} on {s.device} does not match n "
                         f"{tuple(n.shape)} on {n.device}")
    for t, name in ((img_v, "img_v"), (img_c, "img_c")):
        backend.check_tensor(t, name, IMAGE_DTYPES, 2)
        if t.shape != (H, W) or t.device != n.device:
            raise ValueError(f"cost_volume_add: {name} {tuple(t.shape)} on {t.device} is not "
                             f"the (H, W) = {(H, W)} of n on {n.device}")
    if KT_cv.shape != (3, 4) or not KT_cv.is_floating_point() or KT_cv.device != n.device:
        raise ValueError(f"cost_volume_add: KT_cv {tuple(KT_cv.shape)} {KT_cv.dtype} on "
                         f"{KT_cv.device} is not a (3, 4) floating matrix on {n.device}")
    rad = int(rad)
    if rad < 0:
        raise ValueError(f"cost_volume_add: rad must be >= 0, got {rad}")
    fv_img, fc_img = img_v.to(torch.float32), img_c.to(torch.float32)
    M = KT_cv.to(torch.float32).contiguous()
    n_out, s_out = torch.empty_like(n), torch.empty_like(s)
    lib = _build.library()
    with torch.cuda.device(n.device):
        backend.launch(lib.kt_cost_volume_add, n.data_ptr(), s.data_ptr(), fv_img.data_ptr(),
                       fc_img.data_ptr(), M.data_ptr(), n_out.data_ptr(), s_out.data_ptr(), D, H,
                       W, rad, *map(_f32, (K.fu, K.fv, K.u0, K.v0, baseline, 1e-9)),
                       backend.stream_handle(n), op="cost_volume_add")
        launches += 1
    return n_out, s_out
