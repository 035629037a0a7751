"""Multi-device paths (``kangaroo_tpu/parallel/sharding.py``).

Single-controller loops over the shards of a ``parallel.mesh.Mesh``: where
the JAX package runs one program per device under ``shard_map``, the port
runs each shard's work in turn from one host thread, and each collective
becomes a move between devices: ``ppermute`` is ``.to(mesh.devices[dst])``,
``all_to_all`` is slicing plus ``.to``, ``axis_index`` is the loop index,
and ``pmin`` / ``psum`` are reductions over the shards' results on
``mesh.devices[0]``, in shard order. On a mesh of distinct cards the
launches of different shards overlap, since each device runs its own queue;
on a virtual mesh (one card named several times) they run one after
another, and a ``.to`` within a device is the tensor itself, not a copy.

* SGM. Both aggregations take the (D, H, W) cost volume and (H, W)
  intensity on one device and return the aggregate as row blocks, block k
  of H / n rows on ``mesh.devices[k]``; the tail consumes those blocks, and
  only the (H, W) disparity is gathered (``gather_rows``). Each segment runs
  through ``stereo.dispatch``: the kernels on a card, the plain versions on
  the CPU. Every ``if`` of the aggregation tests Python integers: it makes
  no host synchronisation.
* Stencils: rows sharded with a halo (``sharded_stencil_rows``).
* Disparity-sharded stereo: ``sharded_census_wta`` and the DTAM alternation
  ``sharded_dtam_solve``, whose auxiliary search sweeps each shard's slab of
  disparities; plain PyTorch on every device, as the JAX package's XLA.
* A z-sharded volume is a :class:`ZSlabs`: slab k of D / n planes on
  ``mesh.devices[k]`` and the whole volume's box. The fuses run the
  single-device fuse on each slab with the slab's own box and no
  communication (the plane-sweep fuse launches its kernel once a slab on a
  card); the raycasts sweep each slab with a one-plane halo from the next
  shard and keep the nearest hit.
* ICP with the model rows sharded: each shard reduces its rows' system and
  the systems add on ``mesh.devices[0]``.

Every function that takes a volume accepts a :class:`ZSlabs` or a whole
volume, which it shards first, as the JAX functions take a replicated or a
sharded array.
"""
from __future__ import annotations

import dataclasses

import torch

from ..backend import constant, f32_scalars
from ..containers.bbox import BoundingBox
from ..containers.volume import BoundedVolume, TsdfVolume
from ..fusion import raycast as rc
from ..fusion import sdf as sdf_mod
from ..fusion import separable as sep
from ..solvers import icp as icp_mod
from ..solvers.lss import LSS
from ..stereo import census as census_mod
from ..stereo import costvolume as cv
from ..stereo import dispatch as fast
from ..variational import rof as rof_mod
from .mesh import Mesh, shard

AXIS = "shard"
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


# ---------------------------------------------------------------------------
# Row-sharded stencils
# ---------------------------------------------------------------------------


def sharded_stencil_rows(fn, mesh: Mesh, halo: int):
    """Lift ``fn(img) -> img`` (a local stencil of radius <= ``halo``) to
    row shards: shard the rows, take ``halo`` rows from each neighbour
    (the mesh's end blocks replicate their border row, a clamped boundary),
    apply ``fn``, crop, and gather the rows on ``mesh.devices[0]``."""

    def run(img: torch.Tensor) -> torch.Tensor:
        padded = halo_exchange_rows(shard(img, mesh, 0), halo, mesh)
        return gather_rows([fn(p)[halo:-halo] for p in padded], mesh)

    return run


# ---------------------------------------------------------------------------
# Disparity-sharded stereo
# ---------------------------------------------------------------------------


def _slab_size(D: int, mesh: Mesh, what: str) -> int:
    if D % mesh.size:
        raise ValueError(f"{what}: {D} disparities do not divide the {mesh.size}-way mesh")
    return D // mesh.size


def sharded_census_wta(left_img, right_img, max_disp: int, mesh: Mesh,
                       window: str = "9x7") -> torch.Tensor:
    """Census cost and WTA with the disparity axis sharded. Every shard
    computes both census images, then scores its ascending slab of
    disparities one at a time, keeping a running (min cost, argmin d) with a
    strict ``<`` (cost 1e10 where d > x); the global argmin takes the first
    shard holding the minimum, which is the smallest d, as
    ``cost_vol_minimum``'s. Returns (H, W) int32 disparity on
    ``mesh.devices[0]``."""
    d_per = _slab_size(max_disp, mesh, "sharded_census_wta")
    inv_bits = 1.0 / census_mod.norm_bits(window)
    costs, disps = [], []
    for k, dev in enumerate(mesh.devices):
        cl = census_mod.census(left_img.to(dev), window)
        cr = census_mod.census(right_img.to(dev), window)
        H, W, _ = cl.shape
        x = torch.arange(W, device=dev)[None, :]
        best_c = torch.full((H, W), float("inf"), dtype=torch.float32, device=dev)
        best_d = torch.zeros((H, W), dtype=torch.int32, device=dev)
        for d in range(k * d_per, (k + 1) * d_per):
            ham = census_mod.hamming_distance(cl, torch.roll(cr, d, dims=1)).to(torch.float32)
            # d <= x also drops the columns the roll wrapped around
            cost = torch.where(d <= x, ham * inv_bits, 1e10)
            better = cost < best_c
            best_c = torch.where(better, cost, best_c)
            best_d = torch.where(better, d, best_d)
        costs.append(best_c.to(mesh.devices[0]))
        disps.append(best_d.to(mesh.devices[0]))
    win = torch.argmin(torch.stack(costs), dim=0)  # the first shard on a tie
    return torch.stack(disps).gather(0, win[None])[0]


def _dtam_slab_wta(vol_ext, d0_base: int, last_disp, lam, inv2theta, sd: int):
    """The square-penalty search over one shard's slab of disparities.
    ``vol_ext`` is the (dper + 2, H, W) slab with a one-plane halo on each
    side (the mesh's end shards replicate their boundary plane), so the
    parabola's neighbours clamp(bestd -+ 1, 0, D - 1) are slab planes
    ibest and ibest + 2. With ``inv2theta = 0, lam = 1`` this is the plain
    subpixel WTA's arithmetic. Returns the (bestc, bestd, vl, vr) images."""
    slab = vol_ext[1:-1]
    dper, H, W = slab.shape
    dev = slab.device
    dglob = d0_base + torch.arange(dper, dtype=torch.float32, device=dev)[:, None, None]
    dd = last_disp[None] - dglob
    cost = inv2theta * (dd * dd) + lam * slab
    x = torch.arange(W, device=dev)[None, None, :]
    xr = x + sd * dglob
    masked = torch.where((xr >= 0) & (xr < W), cost, 1e10)
    ibest = torch.argmin(masked, dim=0)
    vl = vol_ext.gather(0, ibest[None])[0]
    vr = vol_ext.gather(0, (ibest + 2)[None])[0]
    return masked.amin(0), d0_base + ibest.to(torch.float32), vl, vr


def _dtam_wta_combine(parts, last_disp, lam, inv2theta, sd: int):
    """The global argmin of the shards' (bestc, bestd, vl, vr), all on
    ``last_disp``'s device, and the single-device subpixel refinement. The
    minimum is taken over the shards; on a tie the lowest shard wins (the
    smallest d, as the single-device argmin), and its payloads ride a sum
    masked to the winner. The parabola and the validity masks then follow
    ``costvolume.cost_vol_minimum_square_penalty_subpix``."""
    n = len(parts)
    best_all = torch.stack([p[0] for p in parts]).amin(0)
    mine = [p[0] == best_all for p in parts]
    win = torch.stack([torch.where(m, k, n) for k, m in enumerate(mine)]).amin(0)
    winner = [m & (win == k) for k, m in enumerate(mine)]

    def pick(i):
        out = torch.where(winner[0], parts[0][i], 0.0)
        for w, p in zip(winner[1:], parts[1:]):
            out = out + torch.where(w, p[i], 0.0)
        return out

    bestd, vl, vr = pick(1), pick(2), pick(3)
    dl, dr = bestd - 1.0, bestd + 1.0
    el, er = last_disp - dl, last_disp - dr
    cl = inv2theta * (el * el) + lam * vl
    cr = inv2theta * (er * er) + lam * vr
    subpix = bestd - (cr - cl) / (2.0 * (cr - 2.0 * best_all + cl))
    W = last_disp.shape[-1]
    bestxr = torch.arange(W, dtype=torch.float32, device=bestd.device)[None, :] + sd * bestd
    interior = (bestxr > 0) & (bestxr < W - 1)
    sensible = (subpix > dl) & (subpix < dr)
    return torch.where(interior & sensible, subpix, bestd)


def sharded_dtam_solve(vol, img_left, lam, theta_start, sigma_q, sigma_d, huber_alpha, beta,
                       g_alpha, g_beta, mesh: Mesh, iterations: int = 80,
                       sd: int = -1) -> torch.Tensor:
    """The DTAM alternation with the cost volume's disparity axis sharded.

    The (D, H, W) volume's slabs go to their shards with a one-plane
    disparity halo each side, exchanged once. Each iteration runs the
    image-space half-steps (``weighted_huber_dual_ascent_p``, then
    ``weighted_l2_primal_descent``) once on ``mesh.devices[0]`` (the JAX
    package replicates them on every shard, to the same result), the
    square-penalty search on every shard's slab, and the global argmin of
    :func:`_dtam_wta_combine`; theta follows theta (1 - beta (it + 1)) in
    float32. The seed is the same search with ``inv2theta = 0, lam = 1``,
    which equals ``cost_vol_minimum_subpix`` exactly. Plain PyTorch on every
    device, as the JAX package's sharded solve is plain XLA. Returns the
    (H, W) disparity on ``mesh.devices[0]``."""
    D, H, W = vol.shape
    dper = _slab_size(D, mesh, "sharded_dtam_solve")
    dev0 = mesh.devices[0]
    g_img = img_left.to(device=dev0, dtype=torch.float32)
    if not img_left.dtype.is_floating_point:
        g_img = g_img / 255.0
    g = cv.exponential_edge_weight(g_img, g_alpha, g_beta)
    slabs = [s.to(torch.float32) for s in shard(vol, mesh, 0)]
    n = mesh.size
    exts = []
    for k, (s, dev) in enumerate(zip(slabs, mesh.devices)):
        lo = slabs[k - 1][-1:].to(dev) if k > 0 else s[:1]
        hi = slabs[k + 1][:1].to(dev) if k < n - 1 else s[-1:]
        exts.append(torch.cat([lo, s, hi], dim=0))

    def wta(last_disp, lam_v, inv2theta):
        parts = []
        for k, (ext, dev) in enumerate(zip(exts, mesh.devices)):
            on = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t  # noqa: E731
            part = _dtam_slab_wta(ext, k * dper, last_disp.to(dev), on(lam_v), on(inv2theta),
                                  sd)
            parts.append(tuple(t.to(dev0) for t in part))
        return _dtam_wta_combine(parts, last_disp, lam_v, inv2theta, sd)

    d = wta(torch.zeros((H, W), dtype=torch.float32, device=dev0), 1.0, 0.0)
    a = d
    q = torch.zeros((H, W, 2), dtype=torch.float32, device=dev0)
    lam, theta, sigma_q, sigma_d, huber_alpha, beta = f32_scalars(
        dev0, lam, theta_start, sigma_q, sigma_d, huber_alpha, beta)
    for it in range(iterations):
        q = rof_mod.weighted_huber_dual_ascent_p(q, d, g, sigma_q, huber_alpha)
        d = rof_mod.weighted_l2_primal_descent(d, q, a, g, sigma_d, 1.0 / theta)
        a = wta(d, lam, 0.5 / theta)
        theta = theta * (1.0 - beta * (it + 1.0))
    return d


# ---------------------------------------------------------------------------
# Voxel-z-sharded TSDF fusion and raycast
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ZSlabs:
    """A volume with its z (leading) axis sharded over ``mesh``: slab k,
    planes k D / n .. (k + 1) D / n - 1, on ``mesh.devices[k]``, and the
    whole volume's box. A TSDF holds ``val`` and ``weight``, a
    BoundedVolume (the colour volume) ``data``. Slabs cut from a contiguous
    volume on a virtual mesh are views of it."""

    bbox: BoundingBox
    mesh: Mesh
    val: tuple | None = None
    weight: tuple | None = None
    data: tuple | None = None

    @property
    def is_tsdf(self) -> bool:
        return self.val is not None

    @property
    def shape(self) -> tuple:
        """(D, H, W) of the whole volume."""
        first = (self.val if self.is_tsdf else self.data)[0]
        return (first.shape[0] * self.mesh.size,) + tuple(first.shape[1:])

    @property
    def d(self) -> int:
        return self.shape[0]

    def voxel_size_units(self) -> torch.Tensor:
        D, H, W = self.shape
        return self.bbox.size() / constant((W - 1, H - 1, D - 1), device=self.bbox.device)

    def slab_bbox(self, k: int, extra: int = 0) -> BoundingBox:
        """The world box of slab k on its device, ``extra`` halo planes past
        its end."""
        lo, hi = _slab_bbox_from(self.bbox.lo, self.bbox.hi, self.d, self.mesh.size, k, extra)
        dev = self.mesh.devices[k]
        return BoundingBox(lo.to(dev), hi.to(dev))

    def slab(self, k: int):
        """Slab k as a TsdfVolume or BoundedVolume with its own box."""
        if self.is_tsdf:
            return TsdfVolume(self.val[k], self.weight[k], self.slab_bbox(k))
        return BoundedVolume(self.data[k], self.slab_bbox(k))

    def gather(self):
        """The whole volume on ``mesh.devices[0]`` (a copy)."""
        cat = lambda parts: torch.cat([p.to(self.mesh.devices[0]) for p in parts])  # noqa: E731
        if self.is_tsdf:
            return TsdfVolume(cat(self.val), cat(self.weight), self.bbox)
        return BoundedVolume(cat(self.data), self.bbox)


def _slab_bbox_from(lo, hi, d_total: int, n: int, shard_idx: int, extra: int = 0):
    """(lo, hi) of z-slab ``shard_idx``, ``extra`` planes past its end (the
    caller duplicates the final plane on the last shard, so the cell past
    the volume has no crossing): zlo = lo_z + size_z z0 / (D - 1) in
    float32 on the box's device, as the JAX package rounds it."""
    d_per = d_total // n
    z0 = shard_idx * d_per
    z0_t, z1_t, den = f32_scalars(lo.device, z0, z0 + d_per - 1 + extra, d_total - 1)
    size = hi - lo
    zlo = lo[2] + size[2] * z0_t / den
    zhi = lo[2] + size[2] * z1_t / den
    return torch.stack([lo[0], lo[1], zlo]), torch.stack([hi[0], hi[1], zhi])


def shard_volume_z(vol, mesh: Mesh) -> ZSlabs:
    """A TsdfVolume cut into z-slabs over the mesh (views where a slab is
    already on its device); a :class:`ZSlabs` on this mesh as it is. The
    mesh must divide D (``ValueError``)."""
    if isinstance(vol, ZSlabs):
        if vol.mesh == mesh:
            return vol
        vol = vol.gather()
    return ZSlabs(vol.bbox, mesh, val=tuple(shard(vol.val, mesh, 0)),
                  weight=tuple(shard(vol.weight, mesh, 0)))


def shard_bounded_volume_z(bv, mesh: Mesh) -> ZSlabs:
    """A BoundedVolume (e.g. the colour volume) cut into z-slabs to match."""
    if isinstance(bv, ZSlabs):
        if bv.mesh == mesh:
            return bv
        bv = bv.gather()
    return ZSlabs(bv.bbox, mesh, data=tuple(shard(bv.data, mesh, 0)))


def _to(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def sharded_sdf_fuse(vol, depth, normals, T_cw, K, trunc_dist, max_w, mincostheta,
                     mesh: Mesh) -> ZSlabs:
    """The voxel fuse (``fusion/sdf.sdf_fuse``) on each z-slab with the
    slab's own box: no communication. Returns new slabs."""
    zs = shard_volume_z(vol, mesh)
    outs = [sdf_mod.sdf_fuse(zs.slab(k), depth.to(dev), normals.to(dev), T_cw.to(dev), K,
                             trunc_dist, max_w, mincostheta)
            for k, dev in enumerate(mesh.devices)]
    return ZSlabs(zs.bbox, mesh, val=tuple(o.val for o in outs),
                  weight=tuple(o.weight for o in outs))


def sharded_sdf_fuse_separable(vol, depth, normals, T_cw, K, trunc_dist, max_w, mincostheta,
                               mesh: Mesh, enable=None, near=None, far=None, *,
                               inplace: bool = False) -> ZSlabs:
    """The plane-sweep fuse (``fusion/separable.sdf_fuse_separable``,
    ``sweep_axis=0``) on each z-slab with the slab's own box, so its own
    sweep tables: no communication. On a card each slab is one launch of
    the fuse kernel, on the CPU its plain version. ``enable`` (the tracking
    gate, a bool or a device tensor moved to each shard) and ``near`` /
    ``far`` go to every slab; False is an exact passthrough. Returns new
    slabs, or with ``inplace`` the slabs themselves updated."""
    zs = shard_volume_z(vol, mesh)
    outs = [sep.sdf_fuse_separable(zs.slab(k), depth.to(dev), normals.to(dev), T_cw.to(dev), K,
                                   trunc_dist, max_w, mincostheta, sweep_axis=0,
                                   enable=_to(enable, dev), near=near, far=far, inplace=inplace)
            for k, dev in enumerate(mesh.devices)]
    return ZSlabs(zs.bbox, mesh, val=tuple(o.val for o in outs),
                  weight=tuple(o.weight for o in outs))


def sharded_sdf_fuse_color_separable(vol, color_vol, depth, normals, T_cw, K, img, T_iw, K_img,
                                     trunc_dist, max_w, mincostheta, mesh: Mesh, enable=None,
                                     near=None, far=None, *, inplace: bool = False):
    """The colour-fusing plane-sweep fuse
    (``fusion/separable.sdf_fuse_color_separable``) with both volumes
    z-sharded: each slab pair with the TSDF slab's box, no communication,
    plain PyTorch as on one device. Returns (TSDF slabs, colour slabs)."""
    zs = shard_volume_z(vol, mesh)
    cs = shard_bounded_volume_z(color_vol, mesh)
    outs = []
    for k, dev in enumerate(mesh.devices):
        sub = zs.slab(k)
        outs.append(sep.sdf_fuse_color_separable(
            sub, BoundedVolume(cs.data[k], sub.bbox), depth.to(dev), normals.to(dev),
            T_cw.to(dev), K, img.to(dev), T_iw.to(dev), K_img, trunc_dist, max_w, mincostheta,
            sweep_axis=0, enable=_to(enable, dev), near=near, far=far, inplace=inplace))
    return (ZSlabs(zs.bbox, mesh, val=tuple(v.val for v, _ in outs),
                   weight=tuple(v.weight for v, _ in outs)),
            ZSlabs(cs.bbox, mesh, data=tuple(c.data for _, c in outs)))


def _halo_slab(zs: ZSlabs, k: int) -> TsdfVolume:
    """Slab k with the next shard's first plane appended (the last shard
    repeats its own last plane) and its box one plane longer, so the cell
    between two slabs belongs to the lower one."""
    dev = zs.mesh.devices[k]
    last = k == zs.mesh.size - 1
    nxt = lambda parts: parts[k][-1:] if last else parts[k + 1][:1].to(dev)  # noqa: E731
    return TsdfVolume(torch.cat([zs.val[k], nxt(zs.val)]),
                      torch.cat([zs.weight[k], nxt(zs.weight)]), zs.slab_bbox(k, extra=1))


def _nearest_hit(outs, mesh: Mesh):
    """Combine the shards' (depth, normals, image) on ``mesh.devices[0]``:
    the nearest finite depth wins, the lowest shard on a tie, and the
    normals and image ride a sum masked to the winner (a max would clamp
    negative normal components). NaN where no shard hit."""
    dev0 = mesh.devices[0]
    depths = [torch.where(torch.isfinite(d), d, float("inf")).to(dev0) for d, _, _ in outs]
    best = torch.stack(depths).amin(0)
    mine = [d == best for d in depths]
    n = len(outs)
    win = torch.stack([torch.where(m, k, n) for k, m in enumerate(mine)]).amin(0)
    nrm = img = 0.0
    for k, (m, (_, nk, ik)) in enumerate(zip(mine, outs)):
        w = m & (win == k)
        nrm = nrm + torch.where(w[..., None], nk.to(dev0), 0.0)
        img = img + torch.where(w, ik.to(dev0), 0.0)
    return torch.where(torch.isfinite(best), best, float("nan")), nrm, img


def sharded_raycast(vol, T_wc, K, w: int, h: int, mesh: Mesh, near=0.1, far=10.0,
                    trunc_dist=None, max_steps: int = 512):
    """The sphere-trace raycast (``fusion/raycast.raycast_sdf``) of each
    z-slab with its one-plane halo; the nearest hit wins
    (:func:`_nearest_hit`). Returns (depth, normals, image) on
    ``mesh.devices[0]``."""
    zs = shard_volume_z(vol, mesh)
    return _nearest_hit([rc.raycast_sdf(_halo_slab(zs, k), T_wc.to(dev), K, w, h, near, far,
                                        trunc_dist=trunc_dist, max_steps=max_steps)
                         for k, dev in enumerate(mesh.devices)], mesh)


def sharded_raycast_separable(vol, T_wc, K, w: int, h: int, mesh: Mesh, near=0.1, far=10.0,
                              trunc_dist=None, *, shade: bool = True):
    """The plane-sweep raycast (``fusion/separable.raycast_sdf_separable``)
    of each z-slab with its one-plane halo, swept along z (the sharded
    axis, so a view nearly perpendicular to z loses the single-device
    'auto' axis); the nearest hit wins (:func:`_nearest_hit`). Each slab's
    sweep reads its plane window and orientation on the host: one host
    read a slab. ``shade=False`` skips the Phong image (zeros), which the
    KinectFusion frame does not read. Returns (depth, normals, image) on
    ``mesh.devices[0]``."""
    zs = shard_volume_z(vol, mesh)
    return _nearest_hit([sep.raycast_sdf_separable(_halo_slab(zs, k), T_wc.to(dev), K, w, h,
                                                   near=near, far=far, trunc_dist=trunc_dist,
                                                   shade=shade, sweep_axis=0)
                         for k, dev in enumerate(mesh.devices)], mesh)


# ---------------------------------------------------------------------------
# Row-sharded ICP reduction
# ---------------------------------------------------------------------------


def sharded_icp_point_plane(points_live, points_ref, normals_ref, KT_lr, T_rl, c,
                            mesh: Mesh) -> LSS:
    """Point-plane ICP with the model rows sharded: each shard reduces its
    rows' normal equations against the whole live point image (the
    projective association reads anywhere in it), and the four fields add
    on ``mesh.devices[0]`` in shard order. H must divide the mesh."""
    total = None
    for pr, nr, dev in zip(shard(points_ref, mesh, 0), shard(normals_ref, mesh, 0),
                           mesh.devices):
        s = icp_mod.icp_point_plane(points_live.to(dev), pr, nr, KT_lr.to(dev), T_rl.to(dev),
                                    _to(c, dev))
        s = LSS(*(t.to(mesh.devices[0]) for t in (s.JTJ, s.JTy, s.sqErr, s.obs)))
        total = s if total is None else total + s
    return total
