"""Sorting-network generation and vectorised application
(``kangaroo_tpu/utils/sorting_network.py``).

Equivalent of extra/BitonicSortingNetwork.h (:1-193), which generates
bitonic compare/swap sequences (and printed them as shader code for the
median filters). Here the network is data: a list of (a, b) swaps applied
to whole stacked images at once with ``torch.minimum``/``torch.maximum``
(NaN propagates through both, as through jnp.minimum/maximum). The median
kernel's own networks are generated in ``ops/median_cuda.py``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

Swap = Tuple[int, int]


def _padded_size(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def bitonic_swaps(n: int) -> List[Swap]:
    """Full bitonic sorting network over the power-of-two padding of n
    inputs; apply with +inf in the padded lanes (``apply_network`` does)."""
    p = _padded_size(n)
    swaps: List[Swap] = []
    k = 2
    while k <= p:
        j = k // 2
        while j > 0:
            for i in range(p):
                l = i ^ j
                if l > i:
                    swaps.append((i, l) if (i & k) == 0 else (l, i))
            j //= 2
        k *= 2
    return swaps


def apply_network(values, swaps: List[Swap], n_real: int | None = None):
    """Run a compare/swap network over axis 0 of ``values`` (a list of
    tensors or an (N, ...) tensor): every swap is one elementwise min/max
    pair. Returns the first ``n_real`` lanes as a list. Lanes beyond the
    real inputs are +inf sentinels (the reference clips those swaps at code
    generation, BitonicSortingNetwork.h:18-24; sentinels compose better
    with pruning)."""
    vals = list(values)
    n_real = len(vals) if n_real is None else n_real
    p = _padded_size(n_real)
    inf = torch.full_like(vals[0], float("inf"))
    vals = vals + [inf] * (p - len(vals))
    for a, b in swaps:
        lo = torch.minimum(vals[a], vals[b])
        hi = torch.maximum(vals[a], vals[b])
        vals[a], vals[b] = lo, hi
    return vals[:n_real]


def sort_stack(values):
    """Sort a stack of images elementwise along axis 0."""
    return apply_network(values, bitonic_swaps(len(values)))


def median_swaps(n: int) -> List[Swap]:
    """Pruned network that places the median at index n//2: backward
    liveness pruning of the full sort — the way the ShaderX6 median
    networks the reference's median kernels cite were derived."""
    full = bitonic_swaps(n)
    needed = {n // 2}
    kept: List[Swap] = []
    for a, b in reversed(full):
        if a in needed or b in needed:
            kept.append((a, b))
            needed.add(a)
            needed.add(b)
    kept.reverse()
    return kept


def median_of_stack(values):
    """Elementwise median of an (N, ...) stack via the pruned network
    (lower median for even N)."""
    n = len(values)
    vals = apply_network(values, median_swaps(n), n_real=n)
    return vals[n // 2]
