"""The reject-invalid median kernel (``csrc/median.cu``) and its wrapper.

Counterpart of ``kangaroo_tpu/ops/median_pallas.py`` (``_median_kernel``,
``median_filter`` in reject mode). The plain version is
``ops/median.median_filter_reject_invalid``. The kernel's sorting network
is generated here from the TPU kernel's Batcher pair list and written into
the build directory as ``median_network.cuh``.
"""
from __future__ import annotations

import torch

from .. import _build, backend

# window radii the kernel is instantiated for (csrc/median.cu)
RADII = (1, 2, 3)

# kernel launches since the last reset
launches = 0


def batcher_pairs(n: int) -> list[tuple[int, int]]:
    """Compare-exchange pairs of Batcher's odd-even mergesort for n elements:
    the power-of-two network on the next power of two, pruned to < n."""
    pairs = []

    def merge(lo, cnt, r):
        step = r * 2
        if step < cnt:
            merge(lo, cnt, step)
            merge(lo + r, cnt, step)
            pairs.extend((i, i + r) for i in range(lo + r, lo + cnt - r, step) if i + r < n)
        elif lo + r < n:
            pairs.append((lo, lo + r))

    def sort(lo, cnt):
        if cnt > 1:
            sort(lo, cnt // 2)
            sort(lo + cnt // 2, cnt // 2)
            merge(lo, cnt, 1)

    m = 1
    while m < n:
        m *= 2
    sort(0, m)
    return [(a, b) for a, b in pairs if a < n and b < n]


def network_header() -> str:
    """CUDA source of ``batcher_sort<K>`` for every window size in RADII:
    straight-line min/max pairs with constant indices."""
    lines = ["// Generated by kangaroo_tpu_torch/ops/median_cuda.py; do not edit.",
             "#pragma once",
             "template <int K> __device__ __forceinline__ void batcher_sort(float* v);"]
    for rad in RADII:
        k = (2 * rad + 1) ** 2
        lines.append(f"template <> __device__ __forceinline__ void batcher_sort<{k}>(float* v) {{")
        lines.append("  float lo;")
        for a, b in batcher_pairs(k):
            lines.append(f"  lo = fminf(v[{a}], v[{b}]); v[{b}] = fmaxf(v[{a}], v[{b}]); v[{a}] = lo;")
        lines.append("}")
    return "\n".join(lines) + "\n"


def median_filter_reject_invalid(img: torch.Tensor, max_bad: int, rad: int = 2) -> torch.Tensor:
    """Reject-invalid median of an (H, W) float32 image on the card."""
    global launches
    backend.require_kernels(img, "median")
    backend.check_tensor(img, "img", (torch.float32,), 2)
    if rad not in RADII:
        raise ValueError(f"median kernel takes rad in {RADII}, got {rad}")
    H, W = img.shape
    out = torch.empty_like(img)
    lib = _build.library()
    with torch.cuda.device(img.device):
        rc = lib.kt_median_reject_invalid(img.data_ptr(), out.data_ptr(), H, W, int(rad),
                                          int(max_bad), backend.stream_handle(img))
        backend.check_launch(rc, "median")
        launches += 1
    return out
