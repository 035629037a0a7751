"""SGM stereo frame (``kangaroo_tpu/apps/stereo_sgm.py``).

census volumes -> 4-path (8-path with ``do_diagonal``) semi-global
matching -> WTA + subpixel -> the right disparity from the re-anchored left
aggregate (or a second aggregation) -> reject-invalid median on both images
-> LR check both ways, with the optional guided filter and then the
cross-bilateral filter of each census volume before aggregation (the
reference's "Apply Bilateral Filter"; ``ops/bilateral.bilateral_volume``,
plain PyTorch). ``sgm_pipeline(mesh=)`` runs the aggregation and the tail
over a device mesh (``parallel``), ``sgm_pipeline_batched`` a stacked frame
batch in one aggregation. ``Stereo2App`` (the plane fit and the heightmap
after the frame) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import bilateral as bf
from ..ops import integral_image as ii
from ..parallel import sharding as _sh
from ..parallel.mesh import Mesh
from ..stereo import census as census_mod
from ..stereo import costvolume as cv
from ..stereo import dispatch as fast


def _intensity(img: torch.Tensor) -> torch.Tensor:
    """Intensity on the reference's [0, 1] scale for SGM's adaptive-P2 edge
    term: integer images scale by 1/255, float images are taken as they are."""
    f = img.to(torch.float32)
    if not img.dtype.is_floating_point:
        f = f / 255.0
    return f


@dataclasses.dataclass
class SgmConfig:
    """The frame's parameters; the same fields and defaults as
    ``kangaroo_tpu.apps.stereo_sgm.SgmConfig``."""

    max_disp: int = 64
    census_window: str = "16x16"
    p1: float = 0.01
    p2: float = 0.02  # adaptive P2/(1+|dI|)
    do_horiz: bool = True
    do_vert: bool = True
    do_reverse: bool = True
    do_diagonal: bool = False
    lr_check: bool = True
    max_disp_diff: float = 1.0
    median_its: int = 1
    median_max_bad: int = 12
    subpix: bool = True
    guided_filter: bool = False
    filter_rad: int = 9
    filter_eps: float = 0.01 * 0.01
    bilateral_filter: bool = False
    bilateral_size: int = 18
    bilateral_gs: float = 10.0
    bilateral_gr: float = 6.0
    bilateral_gc: float = 0.01
    # the right disparity from the left aggregate re-anchored on the right
    # lattice (True), or from a second, right-anchored aggregation (False)
    lr_from_left: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "SgmConfig":
        """Build from ``dataclasses.asdict`` of a ``kangaroo_tpu`` SgmConfig."""
        return cls(**d)


def _check_mesh_cfg(cfg: SgmConfig) -> None:
    """Fail fast on SgmConfig features the sharded aggregation lacks."""
    if not (cfg.do_horiz and cfg.do_vert and cfg.do_reverse):
        raise ValueError("mesh-parallel SGM runs the full path set; per-direction flags are "
                         "single-device only")
    if cfg.lr_check and not cfg.lr_from_left:
        raise ValueError("mesh-parallel SGM requires lr_from_left (or lr_check=False)")


def _check_mesh(cfg: SgmConfig, mesh, shape) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError("sgm_pipeline: mesh must be a kangaroo_tpu_torch.parallel.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    _check_mesh_cfg(cfg)
    if shape[0] % mesh.size or shape[1] % mesh.size:
        raise ValueError("the mesh size must divide image H and W (sharded SGM reshards "
                         "between both axes)")


def _filter_volume(vol: torch.Tensor, img: torch.Tensor, cfg: SgmConfig) -> torch.Tensor:
    """The volume filters before aggregation, each slice against the
    image's intensity: the guided filter (``cfg.guided_filter``), then the
    3-weight cross bilateral (``cfg.bilateral_filter``)."""
    if not (cfg.guided_filter or cfg.bilateral_filter):
        return vol
    guide = _intensity(img)
    if cfg.guided_filter:
        vol = ii.guided_filter_volume(vol, guide, cfg.filter_rad, cfg.filter_eps)
    if cfg.bilateral_filter:
        vol = bf.bilateral_volume(vol, guide, cfg.bilateral_gs, cfg.bilateral_gr,
                                  cfg.bilateral_size, gc=cfg.bilateral_gc)
    return vol


def _volume_dtype(cfg: SgmConfig, bits: int) -> torch.dtype:
    """Power-of-two normalisers make every cost k/bits exact in bfloat16;
    the volume filters' arithmetic is not, so a filtered volume stays
    float32."""
    if cfg.guided_filter or cfg.bilateral_filter or bits & (bits - 1):
        return torch.float32
    return torch.bfloat16


def sgm_pipeline(left: torch.Tensor, right: torch.Tensor, cfg: SgmConfig = SgmConfig(),
                 mesh=None) -> torch.Tensor:
    """Full SGM frame for the left image of a rectified (H, W) pair; returns
    float32 disparity with NaN invalids, on the inputs' device.

    ``mesh`` (``parallel.mesh.Mesh``) runs the aggregation, the dominant
    frame cost, over the mesh's shards: the reshard strategy for 4-path
    (column-sharded vertical scans, one all-to-all, row-sharded horizontal
    ones), the carry wavefront for 8-path. The tail runs on the
    aggregate's row blocks, and the disparity is gathered on
    ``mesh.devices[0]``. Census and the cost volume run on the inputs'
    device. It needs the default full path set and ``lr_from_left``, and
    the mesh size must divide H and W."""
    if mesh is not None:
        _check_mesh(cfg, mesh, left.shape)
    cl = census_mod.census(left, cfg.census_window)
    cr = census_mod.census(right, cfg.census_window)
    bits = census_mod.norm_bits(cfg.census_window)
    vol_dtype = _volume_dtype(cfg, bits)

    vol_l = _filter_volume(
        census_mod.census_cost_volume(cl, cr, cfg.max_disp, -1, bits, dtype=vol_dtype),
        left, cfg)
    if mesh is not None:
        if cfg.do_diagonal:
            agg = _sh.sharded_semi_global_matching(vol_l, _intensity(left), cfg.p1, cfg.p2,
                                                   mesh, do_diagonal=True)
        else:
            agg = _sh.sharded_semi_global_matching_reshard(vol_l, _intensity(left), cfg.p1,
                                                           cfg.p2, mesh)
        disp = _sh.sharded_sgm_tail(agg, mesh, cfg.max_disp, subpix=cfg.subpix,
                                    lr_check=cfg.lr_check, max_disp_diff=cfg.max_disp_diff,
                                    median_its=cfg.median_its,
                                    median_max_bad=cfg.median_max_bad)
        return _sh.gather_rows(disp, mesh)
    agg_l = fast.semi_global_matching(vol_l, _intensity(left), cfg.p1, cfg.p2, cfg.do_horiz,
                                      cfg.do_vert, cfg.do_reverse, cfg.do_diagonal)
    if cfg.subpix:
        disp_l = fast.cost_vol_minimum_subpix(agg_l, -1)
    else:
        disp_l = cv.cost_vol_minimum(agg_l, cfg.max_disp).to(torch.float32)

    if cfg.lr_check:
        if cfg.lr_from_left:
            agg_r = cv.reanchor_right(agg_l)
        else:
            vol_r = _filter_volume(
                census_mod.census_cost_volume(cr, cl, cfg.max_disp, 1, bits, dtype=vol_dtype),
                right, cfg)
            agg_r = fast.semi_global_matching(vol_r, _intensity(right), cfg.p1, cfg.p2,
                                              cfg.do_horiz, cfg.do_vert, cfg.do_reverse,
                                              cfg.do_diagonal, sd=1)
        if cfg.subpix:
            disp_r = fast.cost_vol_minimum_subpix(agg_r, 1)
        else:
            disp_r = cv.cost_vol_minimum(agg_r, cfg.max_disp).to(torch.float32)

    # median both images before the LR check (stereo2/main.cpp:438-445)
    for _ in range(cfg.median_its):
        disp_l = fast.median_filter_reject_invalid(disp_l, cfg.median_max_bad, rad=2)
        if cfg.lr_check:
            disp_r = fast.median_filter_reject_invalid(disp_r, cfg.median_max_bad, rad=2)
    if cfg.lr_check:
        # both directions in reference order: disp_r is checked first, so the
        # second check also rejects left pixels whose partner was rejected
        disp_l, _ = fast.left_right_check_pair(disp_l, disp_r, cfg.max_disp_diff,
                                               max_disp=cfg.max_disp)
    return disp_l


def sgm_pipeline_batched(lefts: torch.Tensor, rights: torch.Tensor,
                         cfg: SgmConfig = SgmConfig()) -> torch.Tensor:
    """SGM over a batch of (B, H, W) rectified pairs on one device; returns
    (B, H, W) disparity, each frame equal to ``sgm_pipeline``'s.

    The frames stack along the rows: census runs per frame (its window must
    not read across a seam), the cost volume on the stacked census images
    (its shifts are along x), one aggregation re-seeds the vertical paths at
    every seam (``seam_period=H``, kernel 7), WTA, re-anchor and LR check
    run stacked (row-local), the median on the stack of frames, each with
    its own edges. Configurations whose stages would read across a seam or
    that the stacked aggregation lacks (``do_diagonal``,
    ``lr_from_left=False``, either volume filter) run ``sgm_pipeline`` frame
    by frame, as in the JAX package."""
    B, H, W = lefts.shape
    if (cfg.do_diagonal or not cfg.lr_from_left or cfg.guided_filter
            or cfg.bilateral_filter):
        return torch.stack([sgm_pipeline(lefts[k], rights[k], cfg) for k in range(B)])
    bits = census_mod.norm_bits(cfg.census_window)
    vol_dtype = _volume_dtype(cfg, bits)
    cl = torch.cat([census_mod.census(lefts[k], cfg.census_window) for k in range(B)])
    cr = torch.cat([census_mod.census(rights[k], cfg.census_window) for k in range(B)])
    vol = census_mod.census_cost_volume(cl, cr, cfg.max_disp, -1, bits, dtype=vol_dtype)
    agg_l = fast.semi_global_matching(vol, _intensity(lefts.reshape(B * H, W)), cfg.p1,
                                      cfg.p2, cfg.do_horiz, cfg.do_vert, cfg.do_reverse,
                                      seam_period=H)
    if cfg.subpix:
        disp_l = fast.cost_vol_minimum_subpix(agg_l, -1)
    else:
        disp_l = cv.cost_vol_minimum(agg_l, cfg.max_disp).to(torch.float32)
    if cfg.lr_check:
        agg_r = cv.reanchor_right(agg_l)
        if cfg.subpix:
            disp_r = fast.cost_vol_minimum_subpix(agg_r, 1)
        else:
            disp_r = cv.cost_vol_minimum(agg_r, cfg.max_disp).to(torch.float32)

    def median_per_frame(d):  # the 5x5 stencil must not read across a seam
        return fast.median_filter_reject_invalid(d.reshape(B, H, W), cfg.median_max_bad,
                                                 rad=2).reshape(B * H, W)

    for _ in range(cfg.median_its):
        disp_l = median_per_frame(disp_l)
        if cfg.lr_check:
            disp_r = median_per_frame(disp_r)
    if cfg.lr_check:
        disp_l, _ = fast.left_right_check_pair(disp_l, disp_r, cfg.max_disp_diff,
                                               max_disp=cfg.max_disp)
    return disp_l.reshape(B, H, W)
