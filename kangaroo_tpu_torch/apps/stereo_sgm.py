"""SGM stereo frame (``kangaroo_tpu/apps/stereo_sgm.py``, single device).

census volumes -> 4-path (8-path with ``do_diagonal``) semi-global
matching -> WTA + subpixel -> the right disparity from the re-anchored left
aggregate (or a second aggregation) -> reject-invalid median on both images
-> LR check both ways, with the optional guided filter of each census
volume before aggregation. Not ported yet, and refused with
``NotImplementedError``: the multi-device ``mesh`` and the bilateral
volume filter.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import integral_image as ii
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


def _check_supported(cfg: SgmConfig, mesh) -> None:
    for unported, name in ((mesh is not None, "mesh (multi-device SGM)"),
                           (cfg.bilateral_filter, "bilateral_filter")):
        if unported:
            raise NotImplementedError(f"sgm_pipeline: {name} is not ported yet")


def _filter_volume(vol: torch.Tensor, img: torch.Tensor, cfg: SgmConfig) -> torch.Tensor:
    """The guided filter of every volume slice against the image's
    intensity, when ``cfg.guided_filter`` is set."""
    if not cfg.guided_filter:
        return vol
    return ii.guided_filter_volume(vol, _intensity(img), cfg.filter_rad, cfg.filter_eps)


def sgm_pipeline(left: torch.Tensor, right: torch.Tensor, cfg: SgmConfig = SgmConfig(),
                 mesh=None) -> torch.Tensor:
    """Full SGM frame for the left image of a rectified (H, W) pair; returns
    float32 disparity with NaN invalids, on the inputs' device."""
    _check_supported(cfg, mesh)
    cl = census_mod.census(left, cfg.census_window)
    cr = census_mod.census(right, cfg.census_window)
    bits = census_mod.norm_bits(cfg.census_window)
    # power-of-two normalisers make every cost k/bits exact in bfloat16; the
    # guided filter's arithmetic is not, so a filtered volume stays float32
    vol_dtype = (torch.float32 if cfg.guided_filter
                 else torch.bfloat16 if bits & (bits - 1) == 0 else torch.float32)

    vol_l = _filter_volume(
        census_mod.census_cost_volume(cl, cr, cfg.max_disp, -1, bits, dtype=vol_dtype),
        left, cfg)
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
        disp_r = fast.left_right_check(disp_r, disp_l, 1, cfg.max_disp_diff,
                                       max_disp=cfg.max_disp)
        disp_l = fast.left_right_check(disp_l, disp_r, -1, cfg.max_disp_diff,
                                       max_disp=cfg.max_disp)
    return disp_l
