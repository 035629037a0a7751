"""Census transform, Hamming-cost volume and WTA Hamming stereo
(``kangaroo_tpu/stereo/census.py``).

Descriptors keep the JAX package's (H, W, K) layout of 32-bit words (bit i
of word k is comparison 32*k + i), stored in int64: PyTorch has no shift
for uint32 and no popcount on the CPU, so the words hold values below 2**32
in int64 and the popcount is a SWAR sequence. The words compare exactly
with ``kangaroo_tpu``'s uint32 words cast to int64.

``census`` and ``census_cost_volume`` on a CUDA tensor run the kernels of
``csrc/census.cu`` (``census_cuda``), bit-equal to the plain versions
``_census_plain`` and ``_census_cost_volume_plain``, which the CPU runs;
arguments the kernels do not take raise there. The JAX package runs
them as XLA outside any Pallas kernel. ``census_stereo`` is plain PyTorch
on every device.
"""
from __future__ import annotations

import torch

from ..utils import profiling
from . import census_cuda

# (offsets, capacity_bits): capacity matches sizeof(T)*8, the reference's
# score normaliser (cu_census.cu:293)
_WINDOWS = {
    "9x7": ([(r, c) for r in range(-3, 4) for c in range(-4, 5)], 64),
    "11x11": ([(r, c) for r in range(-5, 6) for c in range(-5, 6)], 128),
    "16x16": ([(r, c) for r in range(-8, 8) for c in range(-4, 4)], 256),
}


def shift_clamped(img: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """img sampled at (y+r, x+c) with clamped borders; over the last two
    axes, so each frame of a (..., H, W) stack is clamped at its own."""
    H, W = img.shape[-2:]
    ys = (torch.arange(H, device=img.device) + r).clamp_(0, H - 1)
    xs = (torch.arange(W, device=img.device) + c).clamp_(0, W - 1)
    return img.index_select(-2, ys).index_select(-1, xs)


@profiling.spanned("stage")
def census(img: torch.Tensor, window: str = "16x16") -> torch.Tensor:
    """Census-transform a grayscale (H, W) image, or each frame of a
    (B, H, W) stack at its own borders -> (..., H, W, K) int64 words holding
    32 bits each; a bit is set when neighbour < centre. A CUDA image takes
    the kernel, one launch for the whole stack (uint8 or float32)."""
    if img.device.type != "cpu":
        return census_cuda.census(img.contiguous(), window)
    return _census_plain(img, window)


def _census_plain(img: torch.Tensor, window: str = "16x16") -> torch.Tensor:
    """``census`` as one pass a window offset; the kernel's yardstick."""
    offsets, _ = _WINDOWS[window]
    n_words = -(-len(offsets) // 32)
    words = [torch.zeros(img.shape, dtype=torch.int64, device=img.device)
             for _ in range(n_words)]
    for k, (r, c) in enumerate(offsets):
        bit = (shift_clamped(img, r, c) < img).to(torch.int64) << (k % 32)
        words[k // 32] |= bit
    return torch.stack(words, dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 entry holding a value in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Popcount of XOR summed over the word axis (int64)."""
    return popcount32(a ^ b).sum(dim=-1)


def norm_bits(window: str) -> int:
    """Bit capacity of the reference's descriptor type, the score normaliser
    (256 for the 16x16 window although it stores 128 comparisons)."""
    return _WINDOWS[window][1]


@profiling.spanned("stage")
def census_cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                       sd: int = -1, bits: int | None = None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """vol[d, y, x] = Hamming(left[y, x], right[y, x + sd*d]) / bits, 0.5 where
    x + sd*d is outside the image. ``left``/``right`` are (H, W, K) census
    images. With a power-of-two ``bits`` every cost k/bits is exact in
    bfloat16, so ``dtype=torch.bfloat16`` halves the volume losslessly.
    CUDA images take the kernel, one launch (up to ``census_cuda.MAX_WORDS``
    words, a bfloat16 or float32 volume, sd = -1 or +1)."""
    if left.device.type != "cpu":
        return census_cuda.census_cost_volume(left.contiguous(), right.contiguous(), max_disp,
                                              sd, bits, dtype)
    return _census_cost_volume_plain(left, right, max_disp, sd, bits, dtype)


def _census_cost_volume_plain(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                              sd: int = -1, bits: int | None = None,
                              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``census_cost_volume`` as one pass a disparity; the kernel's
    yardstick."""
    H, W, K = left.shape
    inv_bits = 1.0 / (bits if bits is not None else K * 32)
    sd = int(sd)
    x = torch.arange(W, device=left.device)
    slices = []
    for d in range(max_disp):
        ok = ((x + sd * d >= 0) & (x + sd * d < W))[None, :]
        # wrapped columns of the roll land where ok is False
        r = torch.roll(right, -sd * d, dims=1)
        ham = hamming_distance(left, r).to(torch.float32) * inv_bits
        slices.append(torch.where(ok, ham, 0.5).to(dtype))
    return torch.stack(slices, dim=0)


def census9x7(img: torch.Tensor) -> torch.Tensor:
    return census(img, "9x7")


def census11x11(img: torch.Tensor) -> torch.Tensor:
    return census(img, "11x11")


def census16x16(img: torch.Tensor) -> torch.Tensor:
    return census(img, "16x16")


def census_stereo(left: torch.Tensor, right: torch.Tensor, max_disp: int) -> torch.Tensor:
    """WTA Hamming disparity of the left census image: the first d in
    [0, min(max_disp, x)) with the least Hamming distance to right[y, x - d];
    int32, -1 where no candidate exists (x = 0)."""
    H, W, K = left.shape
    x = torch.arange(W, device=left.device)
    best_score = torch.full((H, W), 0xFFFFF, dtype=torch.int64, device=left.device)
    best_disp = torch.full((H, W), -1, dtype=torch.int32, device=left.device)
    for d in range(max_disp):
        ok = ((d < x) & (x - d >= 0))[None, :]
        # wrapped columns of the roll land where ok is False
        score = hamming_distance(left, torch.roll(right, d, dims=1))
        better = ok & (score < best_score)
        best_score = torch.where(better, score, best_score)
        best_disp = torch.where(better, d, best_disp)
    return best_disp
