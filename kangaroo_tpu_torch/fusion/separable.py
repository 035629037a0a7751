"""TSDF fusion and raycasting by plane-sweep factorization
(``kangaroo_tpu/fusion/separable.py``).

For voxel plane k the projection (i, j) -> (u, v) is the homography
``H_k = A + k e [0, 0, 1]``; with ``g = A^-1 e`` every plane's homography is
the one per-frame homography ``A`` composed with a per-plane scale and
shift ``S_k(i, j) = ((i + k g0) / (1 + k g2), (j + k g1) / (1 + k g2))``.

* The fuse warps the (depth, cos theta) image once by ``A`` onto an
  intermediate (t, s) grid; each voxel then samples that grid with a
  two-tap lerp along each axis, and applies the TSDF update. On a CUDA
  tensor one kernel does the sampling and the update for every voxel of
  the plane window, in place (``separable_cuda.fuse_planes``,
  ``csrc/separable_fuse.cu``: the port of
  ``kangaroo_tpu/fusion/separable_pallas.py``); on a CPU tensor
  :func:`fuse_planes_plain` does, the transcription of the JAX package's
  XLA scan with its banded lerp matmuls, batch by batch.
* The raycast resamples each volume plane onto the same grid (two banded
  matmuls), finds each ray's zero crossing with a scan over planes, and
  warps the result to pixels once (``output='pixels'``) or returns the
  sweep-grid point cloud (``output='cloud'``). It is plain PyTorch on
  every device; its plane window, its uniform-orientation test and the
  'auto' sweep axis are read on the host (two host reads per raycast, one
  more for 'auto').

The sweep axis (0 = z, 1 = y, 2 = x) takes the volume in its ``[z, y, x]``
layout: the plain code uses permuted views, the kernel maps indices, and
nothing is transposed into a copy. ``'auto'`` picks the axis most parallel
to the view on the host (the first maximum, as ``jnp.argmax``).

The colour fuse (``sdf_fuse_color_separable``) gives the colour camera its
own factorization over the same planes and gates the TSDF update with the
colour test too, so a colour frame's TSDF differs from a depth-only
frame's; it is plain PyTorch on every device (the JAX package takes its
Pallas fuse only without colour). ``normals='gradient'`` differentiates the
swept slabs through the sweep Jacobian on the two-orientation scan over
every plane. The JAX package's ``gather_bits`` routes and the static
``sweep_axis`` pinning for scans are TPU layout work with no counterpart.

Both fuses are differentiable. Where an input requires grad, the plane
loop of ``sdf_fuse_separable`` runs as an autograd op (``_KernelOp``, as
the stereo kernels' in ``stereo/dispatch.py``): its forward is the kernel
on a card (:func:`fuse_planes_plain` on the CPU) on copies of the volume,
its backward the vector-Jacobian product of :func:`fuse_planes_plain_grad`,
the plain loop built out of place; the colour fuse builds its loop out of
place under grad too. The gradient reaches the volume and, through the
warped grids and the params, the depth, the normals and ``T_cw``. The plane
window is read on the host, so PyTorch's autograd through the loop is exact
for the primal it computed; the JAX package's static-trip twin
(``_windowed_fori``'s custom_vjp) works around ``fori_loop`` and has no
counterpart. ``inplace=True`` with an input that requires grad raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..backend import constant, f32_scalars
from ..containers.volume import BoundedVolume, TsdfVolume
from ..core import sampling, se3
from ..geometry import depth as depth_mod
from ..stereo.dispatch import _KernelOp
from .raycast import phong_shade

# world axes playing the (i, j, k) roles for each sweep axis, and the
# permutation of the [z, y, x] volume into [k, j, i] sweep layout
_ORDER = {0: (0, 1, 2), 1: (0, 2, 1), 2: (1, 2, 0)}
_PERM = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}
# depth sentinel of invalid pixels in the fuse warp: any lerp tap with a
# non-zero weight drags the sampled depth below every plausible -trunc
_INVALID_DEPTH = -1e6
# fuse params vector (float32), as separable_pallas: A row-major [0:9],
# g [9:12], s_lo, ds, t_lo, dt [12:16], trunc, max_w, mincostheta [16:19],
# enable [19]
N_PARAMS = 20


class SweepGeom(NamedTuple):
    """Per-frame plane-sweep factorization (float32 tensors)."""

    A: torch.Tensor       # (3, 3) homography: (t, s) grid -> pixels
    Ainv: torch.Tensor    # (3, 3)
    e: torch.Tensor       # (3,) per-plane offset column
    g: torch.Tensor       # (3,) A^-1 e
    s_lo: torch.Tensor    # s of grid column 0
    ds: torch.Tensor      # s per grid column
    t_lo: torch.Tensor
    dt: torch.Tensor


def sweep_shape(shape, axis: int) -> tuple:
    """(D, Hv, Wv) of a [z, y, x] volume shape in sweep layout."""
    return tuple(shape[p] for p in _PERM[axis])


def batch_size(D: int) -> int:
    """Planes per batch of the scans (the JAX package's P): the plane window
    is rounded out to whole batches."""
    return next(p for p in (8, 4, 2, 1) if D % p == 0)


def _homography_parts(vol, T_cw, K, order=(0, 1, 2)):
    R, t = T_cw[:, :3], T_cw[:, 3]
    step = vol.voxel_size_units()  # world units per voxel index along (x, y, z)
    Km = K.matrix(T_cw.device)
    oi, oj, ok = order
    A = Km @ torch.stack([R[:, oi] * step[oi], R[:, oj] * step[oj], R @ vol.bbox.lo + t], dim=1)
    e = Km @ (R[:, ok] * step[ok])
    return A, e


def _plane_scales(g, k):
    """(denom, s-offset, t-offset) of S_k."""
    return 1.0 + k * g[2], k * g[0], k * g[1]


def _nanmin(x):
    m = torch.where(torch.isnan(x), float("inf"), x).amin()
    return torch.where(torch.isnan(x).all(), float("nan"), m)


def _nanmax(x):
    m = torch.where(torch.isnan(x), float("-inf"), x).amax()
    return torch.where(torch.isnan(x).all(), float("nan"), m)


def _image_preimage_range(Ainv, Wi, Hi, axis: int):
    """Range of s (axis 0) or t (axis 1) covered by the image under A^-1;
    (-inf, inf) when the horizon crosses the image."""
    corners = constant(((-2.0, -2.0, 1.0), (Wi + 1.0, -2.0, 1.0), (-2.0, Hi + 1.0, 1.0),
                        (Wi + 1.0, Hi + 1.0, 1.0)), device=Ainv.device)
    q = corners @ Ainv.T
    w = q[:, 2]
    consistent = (w > 1e-9).all() | (w < -1e-9).all()
    vals = q[:, axis] / torch.where(torch.abs(w) < 1e-12, float("nan"), w)
    lo = torch.where(consistent, _nanmin(vals), float("-inf"))
    hi = torch.where(consistent, _nanmax(vals), float("inf"))
    return lo, hi


def _plane_intervals(Ainv, g, n_i, n_j, Wi, Hi, D: int):
    """Per-plane (s, t) footprint intervals, clipped to the image preimage,
    and the per-plane emptiness flags."""
    k = torch.arange(D, dtype=torch.float32, device=g.device)
    denom, off_s, off_t = _plane_scales(g, k)
    ok = torch.abs(denom) > 1e-6
    safe = torch.where(ok, denom, 1.0)

    def axis_iv(n_idx, off, img_axis):
        a = off / safe
        b = (n_idx - 1.0 + off) / safe
        lo_k, hi_k = torch.minimum(a, b), torch.maximum(a, b)
        img_lo, img_hi = _image_preimage_range(Ainv, Wi, Hi, img_axis)
        lo_k = torch.maximum(lo_k, img_lo)
        hi_k = torch.minimum(hi_k, img_hi)
        return lo_k, hi_k, (~ok) | (lo_k > hi_k)

    return axis_iv(n_i, off_s, 0), axis_iv(n_j, off_t, 1)


def make_sweep_geom(vol, T_cw, K, Wi: int, Hi: int, grid_w: int, grid_h: int,
                    from_planes: bool = True, order=(0, 1, 2)) -> SweepGeom:
    """The factorization plus a grid window covering the union of the plane
    footprints clipped to the image preimage. Float32 throughout, on
    ``T_cw``'s device, with no host read. ``from_planes`` is accepted and
    ignored, as in the JAX package."""
    del from_planes
    A, e = _homography_parts(vol, T_cw, K, order)
    Ainv = torch.linalg.inv_ex(A).inverse
    g = Ainv @ e
    counts = vol.val.shape[::-1]  # voxel counts along world (x, y, z)
    n_i, n_j, D = counts[order[0]], counts[order[1]], counts[order[2]]
    (s_lo_k, s_hi_k, s_empty), (t_lo_k, t_hi_k, t_empty) = _plane_intervals(
        Ainv, g, n_i, n_j, Wi, Hi, D)

    def axis_range(n_idx, lo_k, hi_k, empty):
        lo = torch.where(empty, float("inf"), lo_k).amin()
        hi = torch.where(empty, float("-inf"), hi_k).amax()
        # every plane empty (the frame misses the volume): any finite window
        bad = ~(torch.isfinite(lo) & torch.isfinite(hi) & (lo < hi))
        return torch.where(bad, 0.0, lo), torch.where(bad, float(n_idx - 1.0), hi)

    s_lo, s_hi = axis_range(n_i, s_lo_k, s_hi_k, s_empty)
    t_lo, t_hi = axis_range(n_j, t_lo_k, t_hi_k, t_empty)
    ds = (s_hi - s_lo) / (grid_w - 1)
    dt = (t_hi - t_lo) / (grid_h - 1)
    return SweepGeom(A, Ainv, e, g, s_lo, ds, t_lo, dt)


def _grid_st(geom: SweepGeom, grid_w: int, grid_h: int):
    dev = geom.A.device
    s = geom.s_lo + geom.ds * torch.arange(grid_w, dtype=torch.float32, device=dev)
    t = geom.t_lo + geom.dt * torch.arange(grid_h, dtype=torch.float32, device=dev)
    return s, t


def _grid_uv(geom: SweepGeom, s, t):
    """Pixel coordinates of every (t, s) grid point under A: (gh, gw) each."""
    A = geom.A
    S, T = s[None, :], t[:, None]
    den = A[2, 0] * S + A[2, 1] * T + A[2, 2]
    den = torch.where(torch.abs(den) < 1e-12, float("nan"), den)
    return (A[0, 0] * S + A[0, 1] * T + A[0, 2]) / den, (A[1, 0] * S + A[1, 1] * T + A[1, 2]) / den


def _lerp_weight(d):
    """Two-tap lerp weight with weights at or below 1e-6 snapped to zero (so
    the -1e6 invalid-depth sentinel cannot leak in through a tiny weight)."""
    w = torch.clamp(1.0 - torch.abs(d), min=0.0)
    return torch.where(w > 1e-6, w, 0.0)


def _lerp_matrix_batch(pos, n_in: int):
    """Banded lerp matrices: pos (P, M) -> (P, M, n_in)."""
    idx = torch.arange(n_in, dtype=torch.float32, device=pos.device)
    return _lerp_weight(pos[..., None] - idx)


def _view_axis_index(T_cw) -> int:
    """Sweep axis most parallel to the camera's optical axis (row 2 of R_cw):
    0 for a z sweep, 1 for y, 2 for x; the first on a tie. A host read."""
    view = torch.abs(T_cw[2, :3])
    return int(torch.argmax(torch.stack([view[2], view[1], view[0]])))


# ---------------------------------------------------------------------------
# Fusion
# ---------------------------------------------------------------------------


def _visible_planes(geom: SweepGeom, depth, valid_img, D: int, n_i: int, n_j: int, Wi: int,
                    Hi: int, trunc_dist, mincostheta, near=None, far=None):
    """Per-plane visibility of the frustum-clipped fuse: footprint emptiness,
    the measured-depth bound and the optional near/far crop."""
    A, g = geom.A, geom.g
    (s_lo_k, s_hi_k, s_empty), (t_lo_k, t_hi_k, t_empty) = _plane_intervals(
        geom.Ainv, g, n_i, n_j, Wi, Hi, D)
    denom_k = 1.0 + torch.arange(D, dtype=torch.float32, device=g.device) * g[2]
    qz_c = torch.stack([denom_k * (A[2, 0] * sc + A[2, 1] * tc + A[2, 2])
                        for sc in (s_lo_k, s_hi_k) for tc in (t_lo_k, t_hi_k)])
    qz_ok = torch.isfinite(qz_c).all(0)
    qz_min, qz_max = qz_c.amin(0), qz_c.amax(0)
    dmax = torch.where(valid_img, depth, float("-inf")).amax()
    far_bound = torch.clamp(dmax, min=0.0) + trunc_dist / mincostheta
    visible = ~(s_empty | t_empty) & ~(qz_ok & (qz_min > far_bound))
    if near is not None:
        visible &= ~(qz_ok & (qz_max < near))
    if far is not None:
        visible &= ~(qz_ok & (qz_min > far))
    return visible


def plane_window(visible: torch.Tensor, P: int) -> torch.Tensor:
    """[k_lo, k_hi) of the visible planes rounded out to whole batches of P,
    as a (2,) int32 tensor on the device (empty when no plane is visible)."""
    D = visible.shape[0]
    v = visible.to(torch.float32)
    any_vis = visible.any()
    k_lo = torch.argmax(v)
    k_hi = D - 1 - torch.argmax(v.flip(0))
    b_lo = torch.where(any_vis, k_lo // P, 0)
    b_hi = torch.where(any_vis, k_hi // P + 1, 0)
    return torch.stack([b_lo * P, b_hi * P]).to(torch.int32)


def _blend(old_val, old_w, new_sd, w_new, max_w):
    """SDF += then LimitWeight; voxels with no update pass through."""
    old_val_safe = torch.where(old_w > 0, old_val, 0.0)
    w_tot = old_w + w_new
    val = torch.where(w_tot > 0, (old_w * old_val_safe + w_new * new_sd)
                      / torch.clamp(w_tot, min=1e-20), old_val)
    return torch.where(w_new > 0, val, old_val), torch.minimum(w_tot, max_w)


def _check_full_f32(t: torch.Tensor, op: str) -> None:
    """The plain fuses' banded matmuls must run in full float32 on the card."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(f"{op}: TF32 matmuls are enabled; the plain fuse needs full float32")


def _plane_batches(val_p, gmd, gct, params, window, Wi: int, Hi: int):
    """The JAX package's fuse scan (``batch_update``) over the plane window,
    batch by batch, with its banded lerp matmuls: yields (plane slice,
    update mask, sd, w) of each batch of the sweep-layout volume ``val_p``
    (the window read on the host)."""
    D, Hv, Wv = val_p.shape
    gh, gw = gmd.shape
    P = batch_size(D)
    dev = val_p.device
    A = params[0:9].reshape(3, 3)
    g = params[9:12]
    s_lo, ds, t_lo, dt, trunc, _, mincos, enable = params[12:20]
    Gm = torch.stack([gmd, gct], dim=-1).reshape(gh, gw * 2)
    iv = torch.arange(Wv, dtype=torch.float32, device=dev)
    jv = torch.arange(Hv, dtype=torch.float32, device=dev)
    ks = torch.arange(D, dtype=torch.float32, device=dev)
    denom_all, offs_all, offt_all = _plane_scales(g, ks)
    k_lo, k_hi = (int(k) for k in window.tolist())
    for k0 in range(k_lo, k_hi, P):
        sl = slice(k0, k0 + P)
        denom, off_s, off_t = denom_all[sl], offs_all[sl], offt_all[sl]
        plane_ok = torch.abs(denom) > 1e-6
        dsafe = torch.where(plane_ok, denom, 1.0)
        s_of_i = (iv[None, :] + off_s[:, None]) / dsafe[:, None]  # (P, Wv)
        t_of_j = (jv[None, :] + off_t[:, None]) / dsafe[:, None]  # (P, Hv)
        si = (s_of_i - s_lo) / ds
        tj = (t_of_j - t_lo) / dt
        Ck = _lerp_matrix_batch(si, gw)
        Rk = _lerp_matrix_batch(tj, gh)
        win_ok = (((tj >= 0.0) & (tj <= gh - 1.0))[:, :, None]
                  & ((si >= 0.0) & (si <= gw - 1.0))[:, None, :])
        # contract grid_h (one matmul over the stacked plane rows), then grid_w
        tmp = (Rk.reshape(P * Hv, gh) @ Gm).reshape(P, Hv, gw, 2)
        CkT = Ck.transpose(1, 2)
        md = torch.bmm(tmp[..., 0], CkT)
        ct = torch.bmm(tmp[..., 1], CkT)
        S, T = s_of_i[:, None, :], t_of_j[:, :, None]
        den_uv = A[2, 0] * S + A[2, 1] * T + A[2, 2]
        qz = dsafe[:, None, None] * den_uv
        den_uv = torch.where(torch.abs(den_uv) < 1e-12, float("nan"), den_uv)
        uu = (A[0, 0] * S + A[0, 1] * T + A[0, 2]) / den_uv
        vv = (A[1, 0] * S + A[1, 1] * T + A[1, 2]) / den_uv
        in_img = (uu >= 2) & (uu < Wi - 2) & (vv >= 2) & (vv < Hi - 2)
        sd = ct * (md - qz)
        w = ct / qz
        update = (plane_ok[:, None, None] & in_img & win_ok & (sd > -trunc)
                  & torch.isfinite(md) & torch.isfinite(w) & (ct > mincos) & (enable > 0.5))
        yield sl, update, sd, w


def _new_sdf(update, sd, w, trunc):
    return (torch.where(update, torch.minimum(torch.maximum(sd, -trunc), trunc), 0.0),
            torch.where(update, w, 0.0))


def fuse_planes_plain(val, weight, gmd, gct, params, window, axis: int, Wi: int, Hi: int):
    """The plain version of the fuse kernel: the JAX package's XLA scan over
    the plane window. Updates ``val``/``weight`` ([z, y, x] float32) in
    place, as the kernel does, through permuted views; reads the window on
    the host. On the card the matmuls must run in full float32."""
    _check_full_f32(val, "fuse_planes_plain")
    perm = _PERM[axis]
    val_p, wgt_p = val.permute(perm), weight.permute(perm)
    trunc, max_w = params[16], params[17]
    for sl, update, sd, w in _plane_batches(val_p, gmd, gct, params, window, Wi, Hi):
        new_sd, w_new = _new_sdf(update, sd, w, trunc)
        val_p[sl], wgt_p[sl] = _blend(val_p[sl], wgt_p[sl], new_sd, w_new, max_w)
    return val, weight


def _assemble(srcs, batches, perm):
    """Each sweep-layout volume of ``srcs`` with the planes of every
    ``(slice, new_0, new_1, ...)`` of ``batches`` replaced by ``new_i``,
    built by concatenation rather than written in place (which would
    overwrite what autograd saved of the old planes), back in [z, y, x]."""
    parts, k = [[] for _ in srcs], 0
    for sl, *news in batches:
        for out, src, new in zip(parts, srcs, news):
            out += [src[k:sl.start], new]
        k = sl.stop
    inv = tuple(perm.index(i) for i in range(3))
    return tuple(torch.cat(out + [src[k:]]).permute(inv) for out, src in zip(parts, srcs))


def fuse_planes_plain_grad(val, weight, gmd, gct, params, window, axis: int, Wi: int,
                           Hi: int):
    """:func:`fuse_planes_plain` built out of place, for autograd: returns
    the new (val, weight), the planes outside the window those of the
    inputs."""
    _check_full_f32(val, "fuse_planes_plain_grad")
    perm = _PERM[axis]
    val_p, wgt_p = val.permute(perm), weight.permute(perm)
    trunc, max_w = params[16], params[17]
    batches = []
    for sl, update, sd, w in _plane_batches(val_p, gmd, gct, params, window, Wi, Hi):
        new_sd, w_new = _new_sdf(update, sd, w, trunc)
        batches.append((sl, *_blend(val_p[sl], wgt_p[sl], new_sd, w_new, max_w)))
    return _assemble((val_p, wgt_p), batches, perm)


def _fuse_copies(val, weight, gmd, gct, params, window, axis: int, Wi: int, Hi: int):
    """The autograd op's forward: the plane loop on copies of the volume."""
    val, weight = val.detach().clone(), weight.detach().clone()
    return fuse_planes(val, weight, gmd.detach(), gct.detach(), params.detach(), window, axis,
                       Wi, Hi)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fuse_planes(val, weight, gmd, gct, params, window, axis: int, Wi: int, Hi: int):
    """The fuse's plane loop, in place: the CUDA kernel on a CUDA tensor (it
    raises off an sm_90 card), :func:`fuse_planes_plain` on a CPU tensor."""
    if val.device.type == "cpu":
        return fuse_planes_plain(val, weight, gmd, gct, params, window, axis, Wi, Hi)
    from . import separable_cuda

    return separable_cuda.fuse_planes(val, weight, gmd, gct, params, window, axis, Wi, Hi)


def _image_costheta(normals, K, Wi: int, Hi: int):
    """Image-space cos theta: dot(n, P_c) / -|P_c| needs only the ray
    direction."""
    ray = K.unproject_grid(Wi, Hi, device=normals.device)
    ray_len = torch.sqrt(ray[..., 0] * ray[..., 0] + ray[..., 1] * ray[..., 1]
                         + ray[..., 2] * ray[..., 2])
    n = normals[..., :3]
    return (n[..., 0] * ray[..., 0] + n[..., 1] * ray[..., 1] + n[..., 2] * ray[..., 2]) \
        / -ray_len


def _nearest_warp(packed, u, v, ok, Wi: int, Hi: int):
    """The (t, s) grid's nearest samples of the packed (H, W, 2) image."""
    ui = torch.clamp(torch.floor(torch.where(ok, u, 0.0) + 0.5), 0, Wi - 1)
    vi = torch.clamp(torch.floor(torch.where(ok, v, 0.0) + 0.5), 0, Hi - 1)
    return packed.reshape(-1, 2)[(vi * Wi + ui).long()]


def fuse_inputs(vol, depth, normals, T_cw, K, trunc_dist, max_w=1000.0, mincostheta=0.1,
                axis: int = 0, grid_w: int | None = None, grid_h: int | None = None,
                warp: str = "nearest", enable=None, clip_planes: bool = True, near=None,
                far=None):
    """Everything the plane loop takes, computed on the volume's device with
    no host read: the warped grids ``gmd``/``gct`` (gh, gw), the (20,)
    float32 ``params`` and the (2,) int32 plane ``window`` (the visible
    planes rounded out to batches; every plane without ``clip_planes``)."""
    dev = vol.val.device
    order = _ORDER[axis]
    Hi, Wi = depth.shape
    grid_w, grid_h = grid_w or Wi, grid_h or Hi
    D, Hv, Wv = sweep_shape(vol.val.shape, axis)
    trunc, max_w_t, mincos = f32_scalars(dev, trunc_dist, max_w, mincostheta)
    geom = make_sweep_geom(vol, T_cw, K, Wi, Hi, grid_w, grid_h, order=order)
    s, t = _grid_st(geom, grid_w, grid_h)
    u, v = _grid_uv(geom, s, t)

    ct_img = _image_costheta(normals, K, Wi, Hi)
    valid_img = torch.isfinite(depth) & torch.isfinite(ct_img)
    packed = torch.stack([torch.where(valid_img, depth, _INVALID_DEPTH),
                          torch.where(valid_img, ct_img, 0.0)], dim=-1)
    # the one gather: warp the packed image onto the (t, s) grid
    uv_ok = sampling.in_bounds(depth, u, v, 0) & torch.isfinite(u) & torch.isfinite(v)
    if warp == "bilinear":
        G = sampling.bilinear(packed, torch.where(uv_ok, u, 0.0), torch.where(uv_ok, v, 0.0))
    elif warp == "nearest":
        G = _nearest_warp(packed, u, v, uv_ok, Wi, Hi)
    else:
        raise ValueError(f"warp must be 'nearest' or 'bilinear', got {warp!r}")
    gmd = torch.where(uv_ok, G[..., 0], _INVALID_DEPTH).contiguous()
    gct = torch.where(uv_ok, G[..., 1], 0.0).contiguous()

    if enable is None or not isinstance(enable, torch.Tensor):
        en = torch.full((), 1.0 if enable is None else float(bool(enable)), device=dev)
    else:
        en = enable.to(device=dev, dtype=torch.float32).reshape(())
    params = torch.cat([geom.A.reshape(-1), geom.g,
                        torch.stack([geom.s_lo, geom.ds, geom.t_lo, geom.dt]),
                        torch.stack([trunc, max_w_t, mincos, en])]).contiguous()
    if clip_planes:
        near_t, far_t = (None if x is None else f32_scalars(dev, x)[0] for x in (near, far))
        visible = _visible_planes(geom, depth, valid_img, D, Wv, Hv, Wi, Hi, trunc, mincos,
                                  near_t, far_t)
        window = plane_window(visible, batch_size(D))
    else:
        window = constant((0, D), torch.int32, dev)
    return gmd, gct, params, window


def fuse_plane_window(vol, depth, normals, T_cw, K, trunc_dist, mincostheta=0.1,
                      sweep_axis: int = 0, near=None, far=None, grid_w: int | None = None,
                      grid_h: int | None = None) -> torch.Tensor:
    """The (D,) mask of the planes the frustum-clipped fuse sweeps for this
    frame (``clip_planes``; before the rounding out to batches)."""
    dev = vol.val.device
    Hi, Wi = depth.shape
    D, Hv, Wv = sweep_shape(vol.val.shape, sweep_axis)
    geom = make_sweep_geom(vol, T_cw, K, Wi, Hi, grid_w or Wi, grid_h or Hi,
                           order=_ORDER[sweep_axis])
    ct_img = _image_costheta(normals, K, Wi, Hi)
    valid_img = torch.isfinite(depth) & torch.isfinite(ct_img)
    trunc, mincos = f32_scalars(dev, trunc_dist, mincostheta)
    near_t, far_t = (None if x is None else f32_scalars(dev, x)[0] for x in (near, far))
    return _visible_planes(geom, depth, valid_img, D, Wv, Hv, Wi, Hi, trunc, mincos, near_t,
                           far_t)


def _check_inplace(op: str, inplace: bool, grad: bool) -> None:
    if inplace and grad:
        raise ValueError(f"{op}: inplace=True with an input that requires grad; autograd needs "
                         "the volume it fused into")


def sdf_fuse_separable(vol, depth, normals, T_cw, K, trunc_dist, max_w=1000.0,
                       mincostheta=0.1, grid_w: int | None = None, grid_h: int | None = None,
                       warp: str = "nearest", sweep_axis: int | str = "auto", enable=None,
                       clip_planes: bool = True, near=None, far=None, *,
                       inplace: bool = False):
    """SdfFuse on the plane sweep: returns the fused :class:`TsdfVolume`.

    ``sweep_axis`` 0/1/2 or 'auto' (a host read of ``T_cw``); ``enable`` (a
    bool or bool tensor) gates the whole update, False being an exact
    passthrough; ``clip_planes`` restricts the loop to the window of
    camera-visible planes (equal to the full sweep); ``near``/``far`` also
    crop planes outside that camera-depth interval (the reference's ROI
    sliders, not equal to the uncropped fuse). The JAX function's value
    semantics hold: new tensors come back and ``vol`` is untouched, unless
    ``inplace`` asks for ``vol``'s own tensors to be updated and returned
    (the KinectFusion frame does, since it replaces its volume anyway).
    Differentiable with respect to the volume, ``depth``, ``normals`` and
    ``T_cw`` (see the module docstring); ``inplace`` then raises.
    """
    grad = _wants_grad(vol.val, vol.weight, depth, normals, T_cw)
    _check_inplace("sdf_fuse_separable", inplace, grad)
    axis = _view_axis_index(T_cw) if sweep_axis == "auto" else int(sweep_axis)
    gmd, gct, params, window = fuse_inputs(vol, depth, normals, T_cw, K, trunc_dist, max_w,
                                           mincostheta, axis, grid_w, grid_h, warp, enable,
                                           clip_planes, near, far)
    Hi, Wi = depth.shape
    if grad:
        val, weight = _KernelOp.apply(_fuse_copies, fuse_planes_plain_grad,
                                      dict(axis=axis, Wi=Wi, Hi=Hi), vol.val, vol.weight, gmd,
                                      gct, params, window)
        return TsdfVolume(val, weight, vol.bbox)
    val, weight = (vol.val, vol.weight) if inplace else (vol.val.clone(), vol.weight.clone())
    fuse_planes(val, weight, gmd, gct, params, window, axis, Wi, Hi)
    return TsdfVolume(val, weight, vol.bbox)


def sdf_fuse_color_separable(vol, color_vol, depth, normals, T_cw, K, img, T_iw, K_img,
                             trunc_dist, max_w=1000.0, mincostheta=0.1,
                             grid_w: int | None = None, grid_h: int | None = None,
                             warp: str = "nearest", sweep_axis: int | str = "auto", enable=None,
                             clip_planes: bool = True, near=None, far=None, *,
                             inplace: bool = False):
    """The colour-fusing SdfFuse on the plane sweep: returns (TsdfVolume,
    BoundedVolume). The colour camera (``T_iw``, ``K_img``; img (Hc, Wc, 3))
    gets its own factorization over the same planes and a nearest-warped
    grey grid, so its sample is two more banded matmuls a batch. A voxel
    updates (TSDF and grey, blended over the old weight) only where the
    colour camera sees it with every lerp tap inside its image. The other
    arguments, and ``inplace``, are :func:`sdf_fuse_separable`'s; plain
    PyTorch on every device, built out of place where an input requires
    grad."""
    grad = _wants_grad(vol.val, vol.weight, color_vol.data, depth, normals, T_cw, img, T_iw)
    _check_inplace("sdf_fuse_color_separable", inplace, grad)
    _check_full_f32(vol.val, "sdf_fuse_color_separable")
    axis = _view_axis_index(T_cw) if sweep_axis == "auto" else int(sweep_axis)
    gmd, gct, params, window = fuse_inputs(vol, depth, normals, T_cw, K, trunc_dist, max_w,
                                           mincostheta, axis, grid_w, grid_h, warp, enable,
                                           clip_planes, near, far)
    Hi, Wi = depth.shape
    gh, gw = gmd.shape
    order, perm = _ORDER[axis], _PERM[axis]
    dev = vol.val.device

    # the colour camera's grey grid: its own sweep geometry, nearest warp
    Hc, Wc = img.shape[:2]
    grey_img = img.to(torch.float32).mean(-1) / 255.0
    geom2 = make_sweep_geom(vol, T_iw, K_img, Wc, Hc, gw, gh, order=order)
    s2, t2 = _grid_st(geom2, gw, gh)
    u2, v2 = _grid_uv(geom2, s2, t2)
    ok2 = sampling.in_bounds(grey_img, u2, v2, 0) & torch.isfinite(u2) & torch.isfinite(v2)
    G2 = _nearest_warp(torch.stack([grey_img, torch.ones_like(grey_img)], dim=-1), u2, v2, ok2,
                       Wc, Hc)
    G2m = torch.where(ok2[..., None], G2, 0.0).reshape(gh, gw * 2)
    A2, g2 = geom2.A, geom2.g

    if grad:
        val, weight, colour = vol.val, vol.weight, color_vol.data
    else:
        val, weight, colour = ((vol.val, vol.weight, color_vol.data) if inplace else
                               (vol.val.clone(), vol.weight.clone(), color_vol.data.clone()))
    val_p, wgt_p, col_p = val.permute(perm), weight.permute(perm), colour.permute(perm)
    batches = []  # under grad: assembled after the loop, not written in place
    D, Hv, Wv = val_p.shape
    iv = torch.arange(Wv, dtype=torch.float32, device=dev)
    jv = torch.arange(Hv, dtype=torch.float32, device=dev)
    denom2_all, offs2_all, offt2_all = _plane_scales(
        g2, torch.arange(D, dtype=torch.float32, device=dev))
    trunc, max_w_t = params[16], params[17]
    for sl, update, sd, w in _plane_batches(val_p, gmd, gct, params, window, Wi, Hi):
        dn2, os2, ot2 = denom2_all[sl], offs2_all[sl], offt2_all[sl]
        P = dn2.shape[0]
        p2_ok = torch.abs(dn2) > 1e-6
        d2safe = torch.where(p2_ok, dn2, 1.0)
        s2_of_i = (iv[None, :] + os2[:, None]) / d2safe[:, None]
        t2_of_j = (jv[None, :] + ot2[:, None]) / d2safe[:, None]
        Ck2 = _lerp_matrix_batch((s2_of_i - geom2.s_lo) / geom2.ds, gw)
        Rk2 = _lerp_matrix_batch((t2_of_j - geom2.t_lo) / geom2.dt, gh)
        tmpc = (Rk2.reshape(P * Hv, gh) @ G2m).reshape(P, Hv, gw, 2)
        Ck2T = Ck2.transpose(1, 2)
        grey = torch.bmm(tmpc[..., 0], Ck2T)
        grey_ok = torch.bmm(tmpc[..., 1], Ck2T)
        Sc, Tc = s2_of_i[:, None, :], t2_of_j[:, :, None]
        denc = A2[2, 0] * Sc + A2[2, 1] * Tc + A2[2, 2]
        denc = torch.where(torch.abs(denc) < 1e-12, float("nan"), denc)
        uc = (A2[0, 0] * Sc + A2[0, 1] * Tc + A2[0, 2]) / denc
        vc = (A2[1, 0] * Sc + A2[1, 1] * Tc + A2[1, 2]) / denc
        in_c = sampling.in_bounds(grey_img, uc, vc, 2)
        update = update & p2_ok[:, None, None] & in_c & (grey_ok > 0.999)
        new_sd, w_new = _new_sdf(update, sd, w, trunc)
        old_w, old_c = wgt_p[sl], col_p[sl]
        c = torch.where(update, (w_new * grey + old_c * old_w)
                        / torch.clamp(w_new + old_w, min=1e-20), old_c)
        v, wt = _blend(val_p[sl], old_w, new_sd, w_new, max_w_t)
        if grad:
            batches.append((sl, v, wt, c))
        else:
            col_p[sl], val_p[sl], wgt_p[sl] = c, v, wt
    if grad:
        val, weight, colour = _assemble((val_p, wgt_p, col_p), batches, perm)
    return TsdfVolume(val, weight, vol.bbox), BoundedVolume(colour, color_vol.bbox)


# ---------------------------------------------------------------------------
# Raycast
# ---------------------------------------------------------------------------


class _Scan(NamedTuple):
    """Carry of the single-orientation crossing scan."""

    prev_val: torch.Tensor
    prev_ok: torch.Tensor
    prev_qz: torch.Tensor
    depth: torch.Tensor
    found: torch.Tensor


class _DualScan(NamedTuple):
    """Carry of the two-orientation scan (frames whose rays mix directions)."""

    prev_val: torch.Tensor
    prev_ok: torch.Tensor
    prev_qz: torch.Tensor
    asc_depth: torch.Tensor
    asc_found: torch.Tensor
    dsc_depth: torch.Tensor
    dsc_found: torch.Tensor
    asc_n: torch.Tensor  # world normals at the crossings (normals='gradient')
    dsc_n: torch.Tensor


def _shifted(first, rest):
    """The previous plane of every plane in a batch: the carry, then the
    batch without its last plane."""
    return torch.cat([first[None], rest[:-1]], dim=0)


def raycast_sdf_separable(vol, T_wc, K, w: int, h: int, near=0.1, far=10.0, trunc_dist=None,
                          grid_w: int | None = None, grid_h: int | None = None,
                          shade: bool = True, normals: str = "depth",
                          sweep_axis: int | str = "auto", output: str = "pixels",
                          clip_planes: bool = True):
    """RaycastSdf as a gather-free plane sweep. ``output='pixels'`` returns
    (depth (h, w), normals (h, w, 4), Phong image); ``output='cloud'`` the
    camera-space model on the sweep grid: (depth (gh, gw), vbo (gh, gw, 4),
    normals (gh, gw, 4)). ``normals='depth'`` derives the normals from the
    depth map; ``'gradient'`` (pixels only) from the volume's gradient at
    the crossing: central differences of the swept slabs along the grid and
    the plane-to-plane difference, taken through the sweep's Jacobian to
    world axes and turned to face the camera, on the two-orientation scan
    over every plane."""
    if normals not in ("depth", "gradient"):
        raise ValueError(f"normals must be 'depth' or 'gradient', got {normals!r}")
    if output not in ("pixels", "cloud"):
        raise ValueError(f"output must be 'pixels' or 'cloud', got {output!r}")
    if output == "cloud" and normals == "gradient":
        raise ValueError("output='cloud' takes the depth-derived normals")
    axis = (_view_axis_index(se3.inverse(T_wc)) if sweep_axis == "auto" else int(sweep_axis))
    return _raycast_axis(vol, T_wc, K, w, h, near, far, trunc_dist, grid_w, grid_h, shade,
                         axis, output, clip_planes, normals == "gradient")


def _raycast_axis(vol, T_wc, K, w, h, near, far, trunc_dist, grid_w, grid_h, shade, axis,
                  output, clip_planes, grad_normals=False):
    dev = vol.val.device
    order, perm = _ORDER[axis], _PERM[axis]
    grid_w, grid_h = grid_w or w, grid_h or h
    val_p, wgt_p = vol.val.permute(perm), vol.weight.permute(perm)
    D, Hv, Wv = val_p.shape
    T_cw = se3.inverse(T_wc)
    geom = make_sweep_geom(vol, T_cw, K, w, h, grid_w, grid_h, order=order)
    A, Ainv, g = geom.A, geom.Ainv, geom.g
    s, t = _grid_st(geom, grid_w, grid_h)
    if trunc_dist is None:
        trunc_dist = 2.0 * vol.voxel_size_units()[order[0]]
    near, far, trunc_dist = f32_scalars(dev, near, far, trunc_dist)

    # camera depth of each (t, s) ray at k = 0 scale: qz_k = denom_k * h2
    h2 = A[2, 0] * s[None, :] + A[2, 1] * t[:, None] + A[2, 2]
    ks = torch.arange(D, dtype=torch.float32, device=dev)
    denom_all, offs_all, offt_all = _plane_scales(g, ks)
    # unobserved voxels read as +trunc (the reference's SdfReset state)
    packed = torch.where(torch.isfinite(val_p) & (wgt_p > 0), val_p, trunc_dist).contiguous()
    # ascending k moves away from the camera iff dqz/dk = g2 h2 >= 0
    ascending = (g[2] * h2 >= 0) | (g[2] == 0)
    P = batch_size(D)

    def resample(k0: int, reverse: bool):
        """(val, in_range, qz) slabs (P, gh, gw) of planes k0 .. k0 + P - 1,
        or of the reversed planes D - 1 - k0 downwards."""
        sl = slice(D - k0 - P, D - k0) if reverse else slice(k0, k0 + P)
        vplanes, denom, off_s, off_t = packed[sl], denom_all[sl], offs_all[sl], offt_all[sl]
        if reverse:
            vplanes, denom, off_s, off_t = (x.flip(0) for x in (vplanes, denom, off_s, off_t))
        plane_ok = torch.abs(denom) > 1e-6
        i_of_s = s[None, :] * denom[:, None] - off_s[:, None]  # (P, gw)
        j_of_t = t[None, :] * denom[:, None] - off_t[:, None]  # (P, gh)
        Ck = _lerp_matrix_batch(i_of_s, Wv)                    # (P, gw, Wv)
        Rk = _lerp_matrix_batch(j_of_t, Hv)                    # (P, gh, Hv)
        val = torch.bmm(torch.bmm(Rk, vplanes), Ck.transpose(1, 2))  # (P, gh, gw)
        ok = (plane_ok[:, None, None]
              & ((j_of_t >= 0.0) & (j_of_t <= Hv - 1.0))[:, :, None]
              & ((i_of_s >= 0.0) & (i_of_s <= Wv - 1.0))[:, None, :])
        qz = denom[:, None, None] * h2
        return val, ok & (qz > near) & (qz < far), qz

    def crossings(c, val, in_range, qz):
        """Down-crossings (+ to -) of the batch, the interpolated depth at
        each, and the previous-plane slabs."""
        prev_val, prev_ok = _shifted(c.prev_val, val), _shifted(c.prev_ok, in_range)
        prev_qz = _shifted(c.prev_qz, qz)
        crossing = in_range & prev_ok & (prev_val > 0) & (val <= 0)
        lam = torch.where(crossing, prev_val, 0.0) / torch.clamp(
            torch.where(crossing, prev_val - val, 1.0), min=1e-20)
        qz_hit = (torch.where(crossing, prev_qz, 0.0)
                  + torch.where(crossing, qz - prev_qz, 0.0) * lam)
        return crossing, qz_hit, prev_val, prev_ok, prev_qz

    def first_of(crossing, found):
        prior = torch.cumsum(crossing.to(torch.int32), dim=0) - crossing.to(torch.int32)
        return crossing & (prior == 0) & ~found

    zero = torch.zeros((grid_h, grid_w), dtype=torch.float32, device=dev)
    fal = torch.zeros((grid_h, grid_w), dtype=torch.bool, device=dev)

    def single(k_range, reverse: bool):
        c = _Scan(zero, fal, zero, zero, fal)
        for k0 in k_range:
            val, in_range, qz = resample(k0, reverse)
            crossing, qz_hit, _, _, _ = crossings(c, val, in_range, qz)
            first = first_of(crossing, c.found)
            c = _Scan(val[-1], in_range[-1], qz[-1],
                      c.depth + torch.where(first, qz_hit, 0.0).sum(0),
                      c.found | crossing.any(0))
        return c.depth, c.found

    if grad_normals:
        steps_w = vol.voxel_size_units()
        voxel = [steps_w[o] for o in order]
        half_inv_ds, half_inv_dt = 0.5 * (1.0 / geom.ds), 0.5 * (1.0 / geom.dt)
        di_dk = s[None, None, :] * g[2] - g[0]
        dj_dk = t[None, :, None] * g[2] - g[1]

    def gradient(k0, val, prev_val):
        """World gradient of the volume at every grid sample of the batch:
        grid-axis central differences (wrapping, as jnp.roll) and the
        plane difference through the sweep Jacobian."""
        denom = denom_all[k0:k0 + P]
        dsafe = torch.where(torch.abs(denom) > 1e-6, denom, 1.0)[:, None, None]
        vol_i = (torch.roll(val, -1, 2) - torch.roll(val, 1, 2)) * half_inv_ds / dsafe
        vol_j = (torch.roll(val, -1, 1) - torch.roll(val, 1, 1)) * half_inv_dt / dsafe
        vol_k = (val - prev_val) - vol_i * di_dk - vol_j * dj_dk
        comps = {order[0]: vol_i / voxel[0], order[1]: vol_j / voxel[1],
                 order[2]: vol_k / voxel[2]}
        return torch.stack([comps[0], comps[1], comps[2]], dim=-1)

    def dual():
        zero3 = torch.zeros((grid_h, grid_w, 3) if grad_normals else (1, 1, 3),
                            dtype=torch.float32, device=dev)
        c = _DualScan(zero, fal, zero, zero, fal, zero, fal, zero3, zero3)
        for k0 in range(0, D, P):
            val, in_range, qz = resample(k0, False)
            crossing, qz_hit, prev_val, prev_ok, prev_qz = crossings(c, val, in_range, qz)
            first = first_of(crossing, c.asc_found)
            # the last up-crossing of the batch (descending rays overwrite)
            rcross = in_range & prev_ok & (val > 0) & (prev_val <= 0)
            rlam = torch.where(rcross, val, 0.0) / torch.clamp(
                torch.where(rcross, val - prev_val, 1.0), min=1e-20)
            rqz_hit = (torch.where(rcross, qz, 0.0)
                       + torch.where(rcross, prev_qz - qz, 0.0) * rlam)
            later = (torch.cumsum(rcross.flip(0).to(torch.int32), dim=0).flip(0)
                     - rcross.to(torch.int32))
            last = rcross & (later == 0)
            any_r = rcross.any(0)
            asc_n, dsc_n = c.asc_n, c.dsc_n
            if grad_normals:
                n_w = gradient(k0, val, prev_val)
                asc_n = asc_n + torch.where(first[..., None], n_w, 0.0).sum(0)
                dsc_n = torch.where(any_r[..., None],
                                    torch.where(last[..., None], n_w, 0.0).sum(0), dsc_n)
            c = _DualScan(val[-1], in_range[-1], qz[-1],
                          c.asc_depth + torch.where(first, qz_hit, 0.0).sum(0),
                          c.asc_found | crossing.any(0),
                          torch.where(any_r, torch.where(last, rqz_hit, 0.0).sum(0),
                                      c.dsc_depth),
                          c.dsc_found | any_r, asc_n, dsc_n)
        return (torch.where(ascending, c.asc_depth, c.dsc_depth),
                torch.where(ascending, c.asc_found, c.dsc_found),
                torch.where(ascending[..., None], c.asc_n, c.dsc_n))

    if grad_normals:
        # the scan with normals runs over every plane, as the JAX package's
        qz_hit, found, n_grad = dual()
    else:
        # the plane window (bit-equal to the full sweep): footprint, [near,
        # far] and the observed-negative shell +-1 plane
        (s_lo_k, s_hi_k, s_empty), (t_lo_k, t_hi_k, t_empty) = _plane_intervals(
            Ainv, g, Wv, Hv, w, h, D)
        qz_c = torch.stack([denom_all * (A[2, 0] * sc + A[2, 1] * tc + A[2, 2])
                            for sc in (s_lo_k, s_hi_k) for tc in (t_lo_k, t_hi_k)])
        qz_ok = torch.isfinite(qz_c).all(0)
        visible = ~(s_empty | t_empty) & ~(qz_ok & ((qz_c.amax(0) < near)
                                                    | (qz_c.amin(0) > far)))
        has_neg = (packed <= 0).flatten(1).any(1)
        hn, vis = has_neg.to(torch.float32), visible.to(torch.float32)
        kneg_lo = torch.argmax(hn) - 1
        kneg_hi = D - torch.argmax(hn.flip(0))
        k_lo = torch.clamp(torch.maximum(torch.argmax(vis), kneg_lo), 0, D - 1)
        k_hi = torch.clamp(torch.minimum(D - 1 - torch.argmax(vis.flip(0)), kneg_hi), 0, D - 1)
        any_vis = visible.any() & has_neg.any() & (k_lo <= k_hi)
        # one host read: orientation and window
        all_asc, all_dsc, any_vis, k_lo, k_hi = torch.stack(
            [x.to(torch.int64)
             for x in (ascending.all(), (~ascending).all(), any_vis, k_lo, k_hi)]).tolist()
        if all_asc or all_dsc:
            if not clip_planes:
                b_lo, b_hi = 0, D // P
            elif not any_vis:
                b_lo = b_hi = 0
            elif all_asc:
                b_lo, b_hi = k_lo // P, k_hi // P + 1
            else:  # the window of the k-reversed volume
                b_lo, b_hi = (D - 1 - k_hi) // P, (D - 1 - k_lo) // P + 1
            qz_hit, found = single(range(b_lo * P, b_hi * P, P), reverse=not all_asc)
        else:
            qz_hit, found, _ = dual()

    if output == "cloud":
        # each grid node lies on an exact camera ray: P_c = qz * unproject(u, v)
        u, v = _grid_uv(geom, s, t)
        ok = found & torch.isfinite(u) & torch.isfinite(v)
        depth_g = torch.where(ok, qz_hit, float("nan"))
        dirx, diry = (u - K.u0) / K.fu, (v - K.v0) / K.fv
        vbo = torch.stack([dirx * depth_g, diry * depth_g, depth_g, torch.ones_like(depth_g)],
                          dim=-1)
        return depth_g, vbo, depth_mod.normals_from_vbo(vbo)

    # final warp: sample the (t, s) results at each pixel's (s, t)
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    den = Ainv[2, 0] * uu + Ainv[2, 1] * vv + Ainv[2, 2]
    den = torch.where(torch.abs(den) < 1e-12, float("nan"), den)
    gs = ((Ainv[0, 0] * uu + Ainv[0, 1] * vv + Ainv[0, 2]) / den - geom.s_lo) / geom.ds
    gt = ((Ainv[1, 0] * uu + Ainv[1, 1] * vv + Ainv[1, 2]) / den - geom.t_lo) / geom.dt
    # a NaN position converts to index 0, as XLA's float-to-int does; inb
    # rejects that pixel
    gi = torch.clamp(torch.floor(gs + 0.5), 0, grid_w - 1).nan_to_num(0.0).long()
    gj = torch.clamp(torch.floor(gt + 0.5), 0, grid_h - 1).nan_to_num(0.0).long()
    inb = (gs > -0.5) & (gs < grid_w - 0.5) & (gt > -0.5) & (gt < grid_h - 0.5)
    flat_idx = gj * grid_w + gi
    if grad_normals:
        len_n = torch.sqrt((n_grad * n_grad).sum(-1, keepdim=True))
        up = constant((0.0, 0.0, 1.0), device=dev)
        n_w = torch.where(len_n > 0, n_grad / torch.clamp(len_n, min=1e-20), up)
        # the gradient points from inside (negative) to outside: turn it to
        # face the camera
        view_w = se3.rotate(T_wc, up)
        n_w = torch.where((n_w * view_w).sum(-1, keepdim=True) > 0, -n_w, n_w)
        out_pack = torch.cat([qz_hit[..., None], n_w, found.to(torch.float32)[..., None]],
                             dim=-1).reshape(-1, 5)
        got = out_pack[flat_idx]
        hit = inb & (got[..., 4] > 0.5)
        depth = torch.where(hit, got[..., 0], float("nan"))
        n_c = se3.rotate_inv(T_wc, got[..., 1:4])
    else:
        got_d = torch.where(found, qz_hit, float("nan")).reshape(-1)[flat_idx]
        hit = inb & torch.isfinite(got_d)
        depth = torch.where(hit, got_d, float("nan"))
        n4 = depth_mod.normals_from_vbo(depth_mod.depth_to_vbo(depth, K))
        n_c = torch.where(torch.isfinite(n4[..., :3]), n4[..., :3], 0.0)
    ones = torch.ones((h, w, 1), dtype=torch.float32, device=dev)
    norm_out = torch.where(hit[..., None], torch.cat([n_c, ones], dim=-1), 0.0)
    if shade:
        p_c = torch.where(hit, depth, 0.0)[..., None] * K.unproject_grid(w, h, device=dev)
        img = torch.where(hit, phong_shade(p_c, n_c), 0.0)
    else:
        img = torch.zeros((h, w), dtype=torch.float32, device=dev)
    return depth, norm_out, img
