"""The reject-invalid median kernel (``csrc/median.cu``), its wrapper and
the sorting networks it runs.

Counterpart of ``kangaroo_tpu/ops/median_pallas.py`` (``_median_kernel``,
``median_filter`` in reject mode). The plain version is
``ops/median.median_filter_reject_invalid``. The networks are generated
here and written into the build directory as ``median_network.cuh``:

- ``batcher_sort<n>``: Batcher's odd-even mergesort on n values, the TPU
  kernel's pair list. The kernel sorts each column of 2r+1 taps with it;
  the design it replaced sorts whole windows of (2r+1)^2.
- ``median_top<r, p>``: the merges of one thread's p pixels, side by side
  along a row. Its inputs are the p + 2r sorted columns the pixels' windows
  cover; its outputs, for each pixel, the top (k + 1) / 2 of its window's k
  taps in ascending order, the only positions the output index
  min((k + bad) / 2, k - 1) can take. Neighbouring pixels share the columns
  they both cover: a range of pixels merges its shared columns once, and
  each half of the range merges its own extra columns into that
  (``thread_network``).

Every merge is Batcher's odd-even merge of two sorted lists, cut to the top
positions the next merge reads: comparators that feed no such position are
taken out (``merge_network``). None is left that never swaps on sorted
lists (the tests check each). Each network is checked over every 0-1 input
of its structure (``check_network``): by the 0-1 principle, min/max
networks that sort every thresholded input sort every input, and a
threshold keeps sorted parts sorted. Sorting is exact, so every such network selects the
same value as any other; only the sign of a zero may come from another tap.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

from .. import _build, backend

# window radii the kernel is instantiated for (csrc/median.cu)
RADII = (1, 2, 3)
# pixels a thread that median_network.cuh holds networks for: csrc/median.cu
# takes one of them (kPix)
PIXELS = (1, 2, 4)

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


@dataclasses.dataclass(frozen=True)
class Network:
    """A straight-line min/max program. Wires 0..inputs-1 are its inputs,
    made of ``parts`` sorted lists in turn (ascending; a part of size 1 is
    any value). Op (out, kind, a, b) sets wire ``out`` to ``kind`` ("min" or
    "max") of wires a and b, each op a new wire. ``outputs`` holds, for each
    result, wires in ascending order: the top len(wires) positions of the
    union of the parts named in ``covers``. ``merges`` lists the (na, nb,
    t) of the ``merge_network``s it is made of."""

    parts: tuple[int, ...]
    ops: tuple[tuple[int, str, int, int], ...]
    outputs: tuple[tuple[int, ...], ...]
    covers: tuple[tuple[int, ...], ...]
    merges: tuple[tuple[int, int, int], ...] = ()

    @property
    def inputs(self) -> int:
        return sum(self.parts)


class _Builder:
    def __init__(self, inputs: int):
        self.next, self.ops = inputs, []

    def op(self, kind, a, b):
        self.ops.append((self.next, kind, a, b))
        self.next += 1
        return self.next - 1

    def inline(self, net: Network, inputs: list[int]) -> list[int]:
        """Append ``net``'s ops on the given input wires; its outputs."""
        wire = dict(enumerate(inputs))
        for out, kind, a, b in net.ops:
            wire[out] = self.op(kind, wire[a], wire[b])
        return [wire[w] for w in net.outputs[0]]


def _odd_even_merge(b: _Builder, A: list[int], B: list[int]) -> list[int]:
    """Batcher's odd-even merge of sorted wire lists of any lengths."""
    if not A or not B:
        return list(A or B)
    if len(A) == len(B) == 1:
        return [b.op("min", A[0], B[0]), b.op("max", A[0], B[0])]
    V = _odd_even_merge(b, A[0::2], B[0::2])
    W = _odd_even_merge(b, A[1::2], B[1::2])
    out, i = [V[0]], 1
    while i < len(V) and i - 1 < len(W):
        out += [b.op("min", W[i - 1], V[i]), b.op("max", W[i - 1], V[i])]
        i += 1
    return out + W[i - 1:] + V[i:]


def _zero_one_inputs(parts, limit=None) -> tuple[list[int], np.ndarray]:
    """Every 0-1 input whose parts are sorted (``limit`` of them drawn at
    random, seeded, where there are more), as one bitset (a Python int, bit
    i for input i) per input wire; and the count of ones of each part in
    each input, (len(parts), inputs)."""
    if limit is not None and np.prod([n + 1.0 for n in parts]) > limit:
        ones = np.random.default_rng(0).integers(0, np.array(parts)[:, None] + 1,
                                                 (len(parts), limit))
    else:
        ones = np.indices([n + 1 for n in parts]).reshape(len(parts), -1)
    wires = []
    for p, n in enumerate(parts):
        for k in range(n):  # a part with c ones has them at its top c wires
            wires.append(_bits(ones[p] >= n - k))
    return wires, ones


def _bits(mask: np.ndarray) -> int:
    return int.from_bytes(np.packbits(mask, bitorder="little").tobytes(), "little")


def _run(ops, wires: list[int]) -> dict[int, int]:
    """The ops on bitset inputs: min is AND, max is OR."""
    vals = dict(enumerate(wires))
    for out, kind, a, b in ops:
        vals[out] = vals[a] & vals[b] if kind == "min" else vals[a] | vals[b]
    return vals


def _prune(ops, outputs):
    """Take out the ops that no output needs."""
    live, kept = {w for o in outputs for w in o}, []
    for op in reversed(ops):
        if op[0] in live:
            kept.append(op)
            live.update(op[2:])
    return tuple(kept[::-1]), tuple(tuple(o) for o in outputs)


@functools.lru_cache(maxsize=None)
def merge_network(na: int, nb: int, t: int) -> Network:
    """The top t of two sorted lists of na and nb values, ascending: an
    odd-even merge without the comparators that feed no output."""
    b = _Builder(na + nb)
    merged = _odd_even_merge(b, list(range(na)), list(range(na, na + nb)))
    ops, outputs = _prune(b.ops, [merged[-t:]])
    return Network((na, nb), ops, outputs, ((0, 1),))


@functools.lru_cache(maxsize=None)
def thread_network(rad: int, pix: int) -> Network:
    """``median_top<rad, pix>``: the pix + 2 rad sorted columns of S = 2 rad
    + 1 taps in, for each of the pix pixels the top T = (S^2 + 1) / 2 of its
    window out. Pixel i covers columns i..i+2 rad. A range of pixels [a, b]
    needs the columns all of them cover, [b, a + 2 rad]; the range's list
    is its parent's list with its own extra columns merged in (from scratch
    where the parent covers none), then each half of the range goes on from
    it, down to single pixels."""
    S = 2 * rad + 1
    T = S * S - S * S // 2
    ncols = pix + 2 * rad
    b = _Builder(ncols * S)
    column = [list(range(j * S, (j + 1) * S)) for j in range(ncols)]

    merges = []

    def merge(A, B):
        t = min(len(A) + len(B), T)
        merges.append((min(len(A), t), min(len(B), t), t))
        return b.inline(merge_network(*merges[-1]), A[-t:] + B[-t:])

    def merged(cols):
        lists = [column[j] for j in cols]
        while len(lists) > 1:
            lists = [merge(lists[i], lists[i + 1]) if i + 1 < len(lists) else lists[i]
                     for i in range(0, len(lists), 2)]
        return lists[0]

    outputs = [None] * pix

    def node(a, z, parent_cols, parent):
        cols = list(range(z, a + 2 * rad + 1))
        if parent_cols:
            extra = [j for j in cols if j not in parent_cols]
            wires = merge(parent, merged(extra)) if extra else parent
        else:
            wires = merged(cols) if cols else []
        if a == z:
            outputs[a] = wires
        else:
            m = (a + z) // 2
            node(a, m, cols, wires)
            node(m + 1, z, cols, wires)

    node(0, pix - 1, [], [])
    ops, outputs = _prune(b.ops, outputs)
    return Network((S,) * ncols, ops, outputs,
                   tuple(tuple(range(i, i + S)) for i in range(pix)), tuple(merges))


def column_network(size: int) -> Network:
    """``batcher_sort<size>`` as a Network: one unsorted list sorted."""
    b = _Builder(size)
    w = list(range(size))
    for i, j in batcher_pairs(size):
        w[i], w[j] = b.op("min", w[i], w[j]), b.op("max", w[i], w[j])
    return Network((1,) * size, tuple(b.ops), (tuple(w),), (tuple(range(size)),))


def check_network(net: Network, limit=None) -> bool:
    """True iff every output list holds the top positions of the union of
    the parts it covers, on every 0-1 input with sorted parts (on ``limit``
    of them drawn at random where there are more)."""
    wires, ones = _zero_one_inputs(net.parts, limit)
    vals = _run(net.ops, wires)
    for out, cover in zip(net.outputs, net.covers):
        total = ones[list(cover)].sum(axis=0)
        n = sum(net.parts[p] for p in cover)
        for k, w in enumerate(out):
            pos = n - len(out) + k  # ascending position in the union
            if vals[w] != _bits(total >= n - pos):
                return False
    return True


def network_counts(rad: int, pix: int) -> dict[str, float]:
    """Min/max operations a pixel: the column sort (each column sorted once
    a pixel), the merges, and the design it replaced (a full network)."""
    S = 2 * rad + 1
    return {"column": 2 * len(batcher_pairs(S)), "merge": len(thread_network(rad, pix).ops) / pix,
            "replaced": 2 * len(batcher_pairs(S * S))}


def network_header() -> str:
    """CUDA source of ``batcher_sort<n>`` for every column and window size
    of RADII, and of ``median_top<r, p>`` for every radius and pixels a
    thread: straight-line min/max with constant indices."""
    lines = ["// Generated by kangaroo_tpu_torch/ops/median_cuda.py; do not edit.",
             "#pragma once",
             "template <int K> __device__ __forceinline__ void batcher_sort(float* v);",
             "template <int R, int P>",
             "__device__ __forceinline__ void median_top(const float* c, float* top);"]
    for n in sorted({s * s for s in (2 * r + 1 for r in RADII)} | {2 * r + 1 for r in RADII}):
        lines.append(f"template <> __device__ __forceinline__ void batcher_sort<{n}>(float* v) {{")
        lines.append("  float lo;")
        for a, b in batcher_pairs(n):
            lines.append(f"  lo = fminf(v[{a}], v[{b}]); v[{b}] = fmaxf(v[{a}], v[{b}]); v[{a}] = lo;")
        lines.append("}")
    for rad, pix in itertools.product(RADII, PIXELS):
        net = thread_network(rad, pix)
        ref = lambda w: f"c[{w}]" if w < net.inputs else f"w{w}"  # noqa: E731
        lines.append("template <>")
        lines.append(f"__device__ __forceinline__ void median_top<{rad}, {pix}>(const float* c, "
                     "float* top) {")
        lines += [f"  const float w{out} = f{kind}f({ref(a)}, {ref(b)});"
                  for out, kind, a, b in net.ops]
        lines += [f"  top[{i}] = {ref(w)};" for i, w in enumerate(w for o in net.outputs for w in o)]
        lines.append("}")
    return "\n".join(lines) + "\n"


def _check_image(img: torch.Tensor) -> None:
    backend.require_kernels(img, "median")
    if img.dim() not in (2, 3):
        raise ValueError(f"img: expected (H, W) or (N, H, W), got shape {tuple(img.shape)}")
    backend.check_tensor(img, "img", (torch.float32,), img.dim())
    if img.numel() == 0:
        raise ValueError(f"img: empty shape {tuple(img.shape)}")


def median_filter_reject_invalid(img: torch.Tensor, max_bad: int, rad: int = 2) -> torch.Tensor:
    """Reject-invalid median of an (H, W) float32 image, or of each image of
    an (N, H, W) stack with its own edges, on the card: one launch."""
    global launches
    _check_image(img)
    if rad not in RADII:
        raise ValueError(f"median kernel takes rad in {RADII}, got {rad}")
    N, H, W = img.shape if img.dim() == 3 else (1, *img.shape)
    out = torch.empty_like(img)
    lib = _build.library()
    with torch.cuda.device(img.device):
        backend.launch(lib.kt_median_reject_invalid, img.data_ptr(), out.data_ptr(), N, H, W,
                       int(rad), int(max_bad), backend.stream_handle(img), op="median")
        launches += 1
    return out


def _median_pixel(img: torch.Tensor, max_bad: int, rad: int = 2) -> torch.Tensor:
    """``median_filter_reject_invalid`` of an (H, W) image through
    ``kt_median_reject_invalid_pixel`` (the one-thread-per-pixel design it
    replaced): the yardstick that the card checks hold the kernel against.
    No path calls it and no count records it."""
    _check_image(img)
    if img.dim() != 2 or rad not in RADII:
        raise ValueError(f"the pixel design takes one (H, W) image and rad in {RADII}")
    H, W = img.shape
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        backend.launch(_build.library().kt_median_reject_invalid_pixel, img.data_ptr(),
                       out.data_ptr(), H, W, int(rad), int(max_bad), backend.stream_handle(img),
                       op="median")
    return out
