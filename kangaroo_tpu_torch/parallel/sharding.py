"""Multi-device SGM (the SGM part of ``kangaroo_tpu/parallel/sharding.py``).

Single-controller loops over the shards of a ``parallel.mesh.Mesh``: where
the JAX package runs one program per device under ``shard_map``, the port
runs each shard's work in turn from one host thread, and each collective
becomes a move between devices: ``ppermute`` is ``.to(mesh.devices[dst])``,
``all_to_all`` is slicing plus ``.to``, ``axis_index`` is the loop index.
On a mesh of distinct cards the launches of different shards overlap,
since each device runs its own queue; on a virtual mesh (one card named
several times) they run one after another, and a ``.to`` within a device is
the tensor itself, not a copy, so every step allocates its carries anew.
Every ``if`` below tests Python integers: the aggregation makes no host
synchronisation.

Both aggregations take the (D, H, W) cost volume and (H, W) intensity on
one device and return the aggregate as row blocks, block k of H / n rows
on ``mesh.devices[k]``; the tail consumes those blocks, and only the
(H, W) disparity is gathered (``gather_rows``). Each segment runs through
``stereo.dispatch``: the kernels on a card, the plain versions on the CPU.
"""
from __future__ import annotations

import torch

from ..stereo import costvolume as cv
from ..stereo import dispatch as fast
from .mesh import Mesh, shard

_BIG = 1e30


def gather_rows(blocks: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Row blocks concatenated on ``mesh.devices[0]``."""
    return torch.cat([b.to(mesh.devices[0]) for b in blocks], dim=0)


def halo_exchange_rows(blocks: list[torch.Tensor], halo: int, mesh: Mesh) -> list[torch.Tensor]:
    """Each row block with ``halo`` rows of its neighbours above and below,
    the mesh's end blocks replicating their own border row (a clamped
    boundary)."""
    n = len(blocks)
    out = []
    for k, (b, dev) in enumerate(zip(blocks, mesh.devices)):
        top = (blocks[k - 1][-halo:].to(dev) if k > 0
               else b[:1].expand(halo, *b.shape[1:]))
        bot = (blocks[k + 1][:halo].to(dev) if k < n - 1
               else b[-1:].expand(halo, *b.shape[1:]))
        out.append(torch.cat([top, b, bot], dim=0))
    return out


def _check_rows(vol: torch.Tensor, img: torch.Tensor, mesh: Mesh, cols: bool) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a kangaroo_tpu_torch.parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    D, H, W = vol.shape
    if tuple(img.shape) != (H, W):
        raise ValueError(f"img {tuple(img.shape)} does not match vol {tuple(vol.shape)}")
    if H % mesh.size or (cols and W % mesh.size):
        raise ValueError(f"image {H}x{W}: the {mesh.size}-way mesh must divide H"
                         + (" and W" if cols else ""))


def sharded_semi_global_matching_reshard(vol: torch.Tensor, img: torch.Tensor, P1: float,
                                         P2: float, mesh: Mesh, sd: int = -1):
    """4-path SGM with each path family on the axis it is independent over:
    column shards run the full-height vertical pair at their lattice offset
    (``sgm_aggregate_scan(lane_offset=)``, kernel 7), one all-to-all moves
    the vertical aggregate to row shards, and the row shards run the
    horizontal pair on top of it (kernel 1). The single-device recurrences
    exactly; only the sum order of the directions differs. H and W must
    divide the mesh."""
    _check_rows(vol, img, mesh, cols=True)
    D, H, W = vol.shape
    n = mesh.size
    Hs, Ws = H // n, W // n
    kmode = "left" if sd < 0 else "right"
    # vertical pair on column shards (full-height recurrences)
    acc_v = [fast.sgm_aggregate_scan(v, i, P1, P2, True, kmode, scan_is_x=False, width=W,
                                     lane_offset=k * Ws)
             for k, (v, i) in enumerate(zip(shard(vol, mesh, 2),
                                            shard(img, mesh, 1)))]
    # all-to-all: row shard k takes rows k*Hs .. of every column shard; then
    # the horizontal pair on its rows, added onto that block in place
    out = []
    for k, (v, i, dev) in enumerate(zip(shard(vol, mesh, 1), shard(img, mesh, 0),
                                        mesh.devices)):
        acc = torch.cat([a[:, k * Hs:(k + 1) * Hs].to(dev) for a in acc_v], dim=2)
        out.append(fast.sgm_aggregate_scan(v, i, P1, P2, True, kmode, scan_is_x=True, acc=acc))
    return out


def sharded_semi_global_matching(vol: torch.Tensor, img: torch.Tensor, P1: float, P2: float,
                                 mesh: Mesh, sd: int = -1, do_diagonal: bool = False):
    """4/8-path SGM with the image rows sharded: the carry wavefront.

    Horizontal paths live inside a row shard. Vertical paths cross the
    shards: shard k continues where shard k - 1 stopped, with the carry
    (prev, best, last intensity) passed down (up for the upward paths), so
    the recurrences are the single-device ones. The vertical wavefront is
    pipelined over n column blocks: at step t shard k runs block t - k
    downward and block t - (n - 1 - k) upward, so both finish in 2n - 1
    steps. With ``do_diagonal`` the four diagonals also ride the wavefront,
    over the full width (a diagonal drifts a column per row), one active
    shard per direction per step, the carry's has-path mask making the
    first segment's all-zero carry its seed.

    Each segment is ``sgm_aggregate_block`` (kernel 7) or
    ``sgm_aggregate_diag_block`` (kernel 6), as in the JAX package's
    kernel variant (``use_kv``), and directions sharing a row orientation
    add onto one buffer per shard in the JAX package's order: forward =
    horizontal pair + down-vertical + down-diagonals, reverse = up-vertical
    + up-diagonals, total = forward + reverse. The column blocks are the
    JAX package's, ceil(W / n) wide, without its padding: the last ones may
    be narrower or empty. A one-shard mesh runs the single-device
    aggregation."""
    _check_rows(vol, img, mesh, cols=False)
    D, H, W = vol.shape
    n = mesh.size
    if n == 1:
        dev = mesh.devices[0]
        return [fast.semi_global_matching(vol.to(dev), img.to(dev), P1, P2,
                                          do_diagonal=do_diagonal, sd=sd)]
    kmode = "left" if sd < 0 else "right"
    vs, ims = shard(vol, mesh, 1), shard(img, mesh, 0)
    Hs = H // n
    # horizontal pair per shard: it starts the forward chain
    res_fwd = [fast.sgm_aggregate_scan(v, i, P1, P2, True, kmode, scan_is_x=True)
               for v, i in zip(vs, ims)]
    res_rev = [torch.zeros((D, Hs, W), dtype=torch.float32, device=d) for d in mesh.devices]
    Wc = -(-W // n)
    blocks = [(b * Wc, min((b + 1) * Wc, W)) for b in range(n)]
    diag_specs = [(dx, up) for up in (False, True) for dx in (1, -1)] if do_diagonal else []

    def diag_seed(dev):
        zero = torch.zeros((W,), dtype=torch.float32, device=dev)
        return (torch.full((D, W), _BIG, dtype=torch.float32, device=dev), zero, zero, zero)

    # carries arriving at each shard for the next step: vertical ones per
    # chain, diagonal ones per direction (prev, best, has, last intensity)
    down, up = [None] * n, [None] * n
    dcar = {spec: [None] * n for spec in diag_specs}
    for spec in diag_specs:
        first = n - 1 if spec[1] else 0
        dcar[spec][first] = diag_seed(mesh.devices[first])
    for t in range(2 * n - 1):
        down_next, up_next = [None] * n, [None] * n
        for k, (v, im) in enumerate(zip(vs, ims)):
            for chain, b, seed_shard, dst, rev in ((down, t - k, 0, k + 1, False),
                                                   (up, t - (n - 1 - k), n - 1, k - 1, True)):
                if not 0 <= b < n or blocks[b][0] >= W:
                    continue
                c0, c1 = blocks[b]
                res = res_rev[k] if rev else res_fwd[k]
                carry = chain[k] if k != seed_shard else (None, None, None)
                _, cp, cb, li = fast.sgm_aggregate_block(
                    v[:, :, c0:c1], im[:, c0:c1], P1, P2, kmode, width=W,
                    seed=k == seed_shard, carry_prev=carry[0], carry_best=carry[1],
                    last_img=carry[2], lane_offset=c0, acc=res[:, :, c0:c1], reverse=rev)
                if 0 <= dst < n:
                    dev = mesh.devices[dst]
                    (up_next if rev else down_next)[dst] = (cp.to(dev), cb.to(dev), li.to(dev))
            for spec in diag_specs:
                dx, rev = spec
                if t != (n - 1 - k if rev else k):
                    continue
                cp, cb, ch, li = dcar[spec][k]
                _, cp, cb, li, ch = fast.sgm_aggregate_diag_block(
                    v, im, cp, cb, ch, li, P1, P2, kmode, dx=dx, width=W,
                    acc=res_rev[k] if rev else res_fwd[k], reverse=rev)
                dst = k - 1 if rev else k + 1
                if 0 <= dst < n:
                    dev = mesh.devices[dst]
                    dcar[spec][dst] = (cp.to(dev), cb.to(dev), ch.to(dev), li.to(dev))
        down, up = down_next, up_next
    return [f + r for f, r in zip(res_fwd, res_rev)]


def sharded_sgm_tail(agg: list[torch.Tensor], mesh: Mesh, max_disp: int, *,
                     subpix: bool = True, lr_check: bool = True, max_disp_diff: float = 1.0,
                     median_its: int = 1, median_max_bad: int = 12) -> list[torch.Tensor]:
    """The frame's tail on the aggregate's row blocks: WTA (subpixel), the
    right disparity from the re-anchored block, the medians on both, the LR
    check both ways. Every stage is row-local but the 5x5 median, which
    takes a 2-row halo from the neighbouring blocks (edge-replicated at the
    mesh ends, as the median pads the image), so each block's result is
    bit-equal to those rows of the single-device tail. Returns the left
    disparity as row blocks."""

    def wta(a, sd):
        if subpix:
            return fast.cost_vol_minimum_subpix(a, sd)
        return cv.cost_vol_minimum(a, max_disp).to(torch.float32)

    def median(blocks):
        padded = halo_exchange_rows(blocks, 2, mesh)
        return [fast.median_filter_reject_invalid(p, median_max_bad, rad=2)[2:-2]
                for p in padded]

    disp_l = [wta(a, -1) for a in agg]
    disp_r = [wta(cv.reanchor_right(a), 1) for a in agg] if lr_check else None
    for _ in range(median_its):
        disp_l = median(disp_l)
        if lr_check:
            disp_r = median(disp_r)
    if lr_check:
        disp_l = [fast.left_right_check_pair(l, r, max_disp_diff, max_disp=max_disp)[0]
                  for l, r in zip(disp_l, disp_r)]
    return disp_l
