"""The census transform and its Hamming cost volume (``csrc/census.cu``) and
their wrappers.

No counterpart among the JAX package's Pallas kernels: ``kangaroo_tpu``
computes both as XLA. The plain versions are ``stereo/census._census_plain``
and ``_census_cost_volume_plain``; the kernels compute the same bits on the
card, one launch an image or a stack of them, and one a volume
(``stereo.census.census`` and ``census_cost_volume`` route every CUDA
tensor here; arguments outside the types and sizes below raise). Their
outputs are integer-valued: no gradient.
"""
from __future__ import annotations

import math

import torch

from .. import _build, backend
from ..utils import profiling

# kernel launches since the last reset
launches = 0
volume_launches = 0

# image types the kernel compares as float32, exactly as the plain version
# compares them
IMAGE_DTYPES = (torch.uint8, torch.float32)
VOLUME_DTYPES = (torch.bfloat16, torch.float32)
MAX_WORDS = 4  # census words a pixel the volume kernel takes
# window -> (kt_census's window id, words a pixel)
WINDOWS = {"9x7": (0, 2), "11x11": (1, 4), "16x16": (2, 4)}


@profiling.spanned("dispatch")
def census(img: torch.Tensor, window: str = "16x16") -> torch.Tensor:
    """The census words of an (H, W) image or a (B, H, W) stack, each frame
    clamped at its own borders: (..., H, W, K) int64 holding 32 bits each.
    ``img`` uint8 or float32, contiguous, on an sm_90 card."""
    global launches
    backend.require_kernels(img, "census")
    if img.dim() not in (2, 3):
        raise ValueError(f"census: expected an (H, W) image or a (B, H, W) stack, got shape "
                         f"{tuple(img.shape)}")
    backend.check_tensor(img, "img", IMAGE_DTYPES, img.dim())
    if window not in WINDOWS:
        raise KeyError(f"census: no window {window!r}; one of {sorted(WINDOWS)}")
    wid, K = WINDOWS[window]
    out = torch.empty(img.shape + (K,), dtype=torch.int64, device=img.device)
    if not out.numel():
        return out
    H, W = img.shape[-2:]
    B = math.prod(img.shape[:-2])
    lib = _build.library()
    with torch.cuda.device(img.device):
        backend.launch(lib.kt_census, img.data_ptr(), int(img.dtype == torch.uint8),
                       out.data_ptr(), B, H, W, wid, backend.stream_handle(img), op="census")
        launches += 1
    return out


@profiling.spanned("dispatch")
def census_cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int, sd: int = -1,
                       bits: int | None = None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """vol[d, y, x] = popcount(left[y, x] ^ right[y, x + sd d]) / bits (a
    float32 product by 1 / bits in float32, then ``dtype``; bits 32 K by
    default), 0.5 outside the row: (max_disp, H, W). ``left``, ``right``
    (H, W, K) int64 census words, K <= ``MAX_WORDS``, contiguous, on one
    sm_90 card; sd -1 or +1."""
    global volume_launches
    backend.require_kernels(left, "census_cost_volume")
    backend.check_tensor(left, "left", (torch.int64,), 3)
    backend.check_tensor(right, "right", (torch.int64,), 3)
    if right.shape != left.shape or right.device != left.device:
        raise ValueError(f"census_cost_volume: right {tuple(right.shape)} on {right.device} "
                         f"does not match left {tuple(left.shape)} on {left.device}")
    H, W, K = left.shape
    if not 1 <= K <= MAX_WORDS:
        raise ValueError(f"census_cost_volume: {K} words a pixel, the kernel takes 1 to "
                         f"{MAX_WORDS}")
    if dtype not in VOLUME_DTYPES:
        raise TypeError(f"census_cost_volume: dtype {dtype} not in {VOLUME_DTYPES}")
    inv_bits = 1.0 / (bits if bits is not None else K * 32)
    sd, D = int(sd), int(max_disp)
    if sd not in (-1, 1) or D < 1:
        raise ValueError(f"census_cost_volume: needs sd of -1 or +1 and max_disp >= 1, got "
                         f"sd {sd}, max_disp {D}")
    vol = torch.empty((D, H, W), dtype=dtype, device=left.device)
    if not vol.numel():
        return vol
    lib = _build.library()
    with torch.cuda.device(left.device):
        backend.launch(lib.kt_census_volume, left.data_ptr(), right.data_ptr(), vol.data_ptr(),
                       int(dtype == torch.bfloat16), D, H, W, K, sd, inv_bits,
                       backend.stream_handle(left), op="census_cost_volume")
        volume_launches += 1
    return vol
