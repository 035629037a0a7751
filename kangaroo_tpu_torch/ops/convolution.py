"""Brute-force 2D convolution (``kangaroo_tpu/ops/convolution.py``).

An arbitrary kernel with anchor (kx, ky), edge-clamped samples on both
axes, output normalised by the kernel sum unless ``normalize=False``. The
padded image keeps the JAX package's shape, one row and one column more
than the taps reach.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def convolve(img: torch.Tensor, kern, kx: int | None = None, ky: int | None = None,
             normalize: bool = True) -> torch.Tensor:
    """(H, W) image convolved with the (kh, kw) kernel; returns float32."""
    f = img.to(torch.float32)
    kern = torch.as_tensor(kern, dtype=torch.float32, device=f.device)
    kh, kw = kern.shape
    if kx is None:
        kx = kw // 2
    if ky is None:
        ky = kh // 2
    H, W = f.shape
    padded = F.pad(f[None, None], (kx, kw - 1 - kx + 1, ky, kh - 1 - ky + 1),
                   mode="replicate")[0, 0]
    acc = torch.zeros_like(f)
    for r in range(kh):
        for c in range(kw):
            acc = acc + kern[r, c] * padded[r:r + H, c:c + W]
    if normalize:
        acc = acc / torch.sum(kern)
    return acc
