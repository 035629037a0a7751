"""Truncated signed-distance fusion per voxel (``kangaroo_tpu/fusion/sdf.py``):
``sdf_fuse`` (the exact engine's bilinear fuse and the guided engine's
nearest one), ``sdf_fuse_color``, ``sdf_reset``, ``sdf_sphere`` and
``sdf_distance``.

Every voxel projects into the depth image, samples depth and normal there
and blends. The JAX package computes the whole (D, H, W) lattice at once;
here the same arithmetic runs over slabs of planes (``_SLAB_VOXELS`` voxels
at a time), so the transient memory is a few hundred MB at 256^3 rather
than a few GB. It is plain PyTorch on every device: the JAX package reaches
no Pallas kernel here. Its ``take_f32`` gather is plain indexing.
"""
from __future__ import annotations

import torch

from ..containers.volume import BoundedVolume, TsdfVolume, voxel_positions
from ..core import sampling, se3

# voxels per slab of planes of the fuse (a slab is at least one plane)
_SLAB_VOXELS = 1 << 22


def _slabs(shape):
    """[z0, z1) plane ranges of about ``_SLAB_VOXELS`` voxels each."""
    D, H, W = shape
    n = max(1, _SLAB_VOXELS // (H * W))
    return [(z0, min(D, z0 + n)) for z0 in range(0, D, n)]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2])


def _project_voxels(P_w, depth, normals, T_cw, K, sample: str = "bilinear"):
    """World voxels -> camera -> pixel samples of depth and normal.
    ``sample``: 'bilinear' (the reference's) or 'nearest' (one gather of a
    packed (depth, normal) image, the guided engine's)."""
    P_c = se3.transform(T_cw, P_w)
    p = K.project(P_c)
    u, v = p[..., 0], p[..., 1]
    in_img = sampling.in_bounds(depth, u, v, 2)
    if sample == "nearest":
        Hi, Wi = depth.shape
        packed = torch.cat([depth[..., None], normals[..., :3]], dim=-1).reshape(-1, 4)
        # a NaN position converts to index 0, as XLA's float-to-int does
        ui = torch.clamp(torch.floor(u + 0.5), 0, Wi - 1).nan_to_num(0.0).long()
        vi = torch.clamp(torch.floor(v + 0.5), 0, Hi - 1).nan_to_num(0.0).long()
        got = packed[vi * Wi + ui]
        md, mdn = got[..., 0], got[..., 1:4]
    elif sample == "bilinear":
        md = sampling.bilinear(depth, u, v)
        mdn = sampling.bilinear(normals, u, v)[..., :3]
    else:
        raise ValueError(f"sample must be 'bilinear' or 'nearest', got {sample!r}")
    vd = P_c[..., 2]
    costheta = (mdn * P_c).sum(-1) / -_norm(P_c)
    sd = costheta * (md - vd)
    w = costheta / vd
    return in_img, md, sd, w, costheta


def _update_mask(in_img, md, sd, w, costheta, trunc_dist, mincostheta):
    return (in_img & (sd > -trunc_dist) & torch.isfinite(md) & torch.isfinite(w)
            & (costheta > mincostheta))


def _blend(old_val, old_w, update, sd, w, trunc_dist):
    """SDF += with the NaN-safe first observation: masked voxels carry zero
    value and weight, and a stored weight of 0 (the reset state, maybe
    val = NaN) is replaced outright. Returns (val, w_new, w_tot) before the
    weight limit."""
    new_sd = torch.where(update, torch.clamp(sd, -trunc_dist, trunc_dist), 0.0)
    w_new = torch.where(update, w, 0.0)
    old_safe = torch.where(old_w > 0, old_val, 0.0)
    w_tot = old_w + w_new
    val = torch.where(w_tot > 0, (old_w * old_safe + w_new * new_sd)
                      / torch.clamp(w_tot, min=1e-20), old_val)
    return val, w_new, w_tot


def sdf_fuse(vol: TsdfVolume, depth, normals, T_cw, K, trunc_dist, max_w=1000.0,
             mincostheta=0.1, sample: str = "bilinear") -> TsdfVolume:
    """Fuse one depth frame into the TSDF (SdfFuse). depth (Hi, Wi) metres;
    normals (Hi, Wi, 4) camera-frame; T_cw (3, 4) world -> camera. Returns a
    new volume; ``vol`` is untouched."""
    val, weight = torch.empty_like(vol.val), torch.empty_like(vol.weight)
    for z0, z1 in _slabs(vol.val.shape):
        P_w = voxel_positions(vol.val.shape, vol.bbox, z0, z1)
        in_img, md, sd, w, ct = _project_voxels(P_w, depth, normals, T_cw, K, sample)
        update = _update_mask(in_img, md, sd, w, ct, trunc_dist, mincostheta)
        old_w = vol.weight[z0:z1]
        val[z0:z1], _, w_tot = _blend(vol.val[z0:z1], old_w, update, sd, w, trunc_dist)
        weight[z0:z1] = torch.clamp(w_tot, max=max_w)
    return TsdfVolume(val, weight, vol.bbox)


def sdf_fuse_color(vol: TsdfVolume, color_vol: BoundedVolume, depth, normals, T_cw, K, img,
                   T_iw, K_img, trunc_dist, max_w=1000.0, mincostheta=0.1):
    """The colour-fusing fuse: img (Hc, Wc, 3) uint8 or float; its grey
    intensity / 255 blends into ``color_vol`` over the old weight wherever
    the TSDF updates, and only where the voxel also projects into img.
    Returns (TsdfVolume, BoundedVolume)."""
    val, weight = torch.empty_like(vol.val), torch.empty_like(vol.weight)
    colour = torch.empty_like(color_vol.data)
    for z0, z1 in _slabs(vol.val.shape):
        P_w = voxel_positions(vol.val.shape, vol.bbox, z0, z1)
        in_img, md, sd, w, ct = _project_voxels(P_w, depth, normals, T_cw, K)
        p_i = K_img.project(se3.transform(T_iw, P_w))
        in_c = sampling.in_bounds(img, p_i[..., 0], p_i[..., 1], 2)
        grey = sampling.bilinear(img, p_i[..., 0], p_i[..., 1]).mean(-1) / 255.0
        update = _update_mask(in_img, md, sd, w, ct, trunc_dist, mincostheta) & in_c
        old_w, old_c = vol.weight[z0:z1], color_vol.data[z0:z1]
        val[z0:z1], w_new, w_tot = _blend(vol.val[z0:z1], old_w, update, sd, w, trunc_dist)
        grey = torch.where(update, grey, 0.0)
        colour[z0:z1] = torch.where(update, (w_new * grey + old_c * old_w)
                                    / torch.clamp(w_new + old_w, min=1e-20), old_c)
        weight[z0:z1] = torch.clamp(w_tot, max=max_w)
    return TsdfVolume(val, weight, vol.bbox), BoundedVolume(colour, color_vol.bbox)


def sdf_reset(vol: TsdfVolume, trunc_dist) -> TsdfVolume:
    """val = trunc_dist, weight = 0 (SdfReset)."""
    return vol.reset(trunc_dist)


def sdf_sphere(vol: TsdfVolume, center, r) -> TsdfVolume:
    """Analytic sphere SDF with weight 1 (SdfSphere)."""
    pos = vol.voxel_positions()
    c = torch.as_tensor(center, dtype=torch.float32, device=pos.device)
    return TsdfVolume(_norm(pos - c) - r, torch.ones_like(vol.weight), vol.bbox)


def sdf_distance(depth, vol: TsdfVolume, T_wc, K):
    """The SDF sampled at each depth-map point (SdfDistance)."""
    H, W = depth.shape
    p_w = se3.transform(T_wc, K.unproject_grid(W, H, depth))
    return vol.sample_trilinear_world(p_w)
