"""SGM stereo frame (``kangaroo_tpu/apps/stereo_sgm.py``).

census volumes -> 4-path (8-path with ``do_diagonal``) semi-global
matching -> WTA + subpixel -> the right disparity from the re-anchored left
aggregate (or a second aggregation) -> reject-invalid median on both images
-> LR check both ways, with the optional guided filter and then the
cross-bilateral filter of each census volume before aggregation (the
reference's "Apply Bilateral Filter"; ``ops/bilateral.bilateral_volume``,
plain PyTorch). ``sgm_pipeline(mesh=)`` runs the aggregation and the tail
over a device mesh (``parallel``), ``sgm_pipeline_batched`` a stacked frame
batch in one aggregation. ``Stereo2App`` runs the frame, then the app's
tail: disparity to points, the robust plane fit and heightmap fusion.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import se3
from ..geometry import depth as depth_mod
from ..geometry.heightmap import HeightmapFusion
from ..ops import bilateral as bf
from ..ops import integral_image as ii
from ..parallel import sharding as _sh
from ..parallel.mesh import Mesh
from ..solvers import plane_fit as pf
from ..stereo import census as census_mod
from ..stereo import costvolume as cv
from ..stereo import dispatch as fast
from ..utils import profiling


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


@profiling.spanned("entry")
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


@profiling.spanned("entry")
def sgm_pipeline_batched(lefts: torch.Tensor, rights: torch.Tensor,
                         cfg: SgmConfig = SgmConfig()) -> torch.Tensor:
    """SGM over a batch of (B, H, W) rectified pairs on one device; returns
    (B, H, W) disparity, each frame equal to ``sgm_pipeline``'s.

    The frames stack along the rows: census runs once a side on the stack,
    each frame clamped at its own borders (its window must not read across a
    seam), the cost volume on the stacked census images
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
    cl = census_mod.census(lefts, cfg.census_window).reshape(B * H, W, -1)
    cr = census_mod.census(rights, cfg.census_window).reshape(B * H, W, -1)
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


class Stereo2App:
    """The stereo2 app: per frame ``sgm_pipeline`` (over ``mesh`` if given)
    -> the disparity's (H, W, 4) points -> 5 Gauss-Newton steps of the
    plane fit continuing the persistent estimate (the first frame runs the
    105-step reset, its Tukey width annealed 16c, 4c, c over 35 steps each)
    -> the world-frame points fused into a heightmap whose grid is laid on
    the first fitted plane (T_nw = (T_wc PlaneBasis_wp(n_c))^-1, centred in
    x). The heightmap is made on the first frame, on the frame's device."""

    def __init__(self, K, baseline: float, cfg: SgmConfig = SgmConfig(), plane_fit: bool = True,
                 heightmap: bool = True, hm_size=(10.0, 10.0), hm_cell: float = 0.1,
                 min_disp: float = 1.0, plane_c: float = 0.5, plane_within: float = 20.0,
                 mesh=None):
        self.K = K
        self.baseline = float(baseline)
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            _check_mesh_cfg(cfg)  # fail at construction, not at the first frame
        self.do_plane = plane_fit
        self.do_heightmap = heightmap
        self.hm_size, self.hm_cell = hm_size, hm_cell
        self.min_disp = min_disp
        self.plane_c = plane_c
        self.plane_within = plane_within
        self.z = None  # persistent plane parameters
        self.n_c = None  # camera-frame plane normal, n . P = -1
        self.Qinv = None
        self.hm = None  # HeightmapFusion, made on the first frame
        self.hm_initialised = False

    def _fit_plane(self, d3d: torch.Tensor, reset: bool) -> None:
        if self.Qinv is None:
            H, W = d3d.shape[:2]
            self.Qinv = pf.make_q_inv(self.K, W, H, device=d3d.device)
        schedule = ((16 * self.plane_c, 35), (4 * self.plane_c, 35), (self.plane_c, 35)) \
            if reset else ((self.plane_c, 5),)
        for c, its in schedule:
            self.n_c, self.z = pf.fit_plane(d3d, self.Qinv, z0=self.z, iterations=its,
                                            zmax=self.plane_within, c=c)

    def _make_heightmap(self, T_wc: torch.Tensor) -> HeightmapFusion:
        """The grid of ``hm_size`` / ``hm_cell``, laid on the fitted plane when
        there is one (one host read of its pose, on the first frame)."""
        hm = HeightmapFusion(self.hm_size[0], self.hm_size[1], self.hm_cell, device=T_wc.device)
        if self.n_c is None:
            return hm
        T_nw = se3.inverse(se3.compose(T_wc, pf.plane_basis_wp(self.n_c))).cpu().numpy()
        T_nw[0, 3] += hm.w * hm.cell_size / 2
        T_nw[1, 3] += hm.h * hm.cell_size
        return HeightmapFusion(hm.w * hm.cell_size, hm.h * hm.cell_size, hm.cell_size,
                               T_hw=T_nw, device=T_wc.device)

    def __call__(self, left: torch.Tensor, right: torch.Tensor, T_wc=None, image=None):
        """Process one rectified frame; returns ``(disp, d3d)``. The plane
        lands in ``n_c``/``z`` and the heightmap in ``hm``. ``T_wc`` (3, 4)
        is the camera pose feeding the heightmap (the identity by default);
        ``image`` (H, W) colours its cells."""
        disp = sgm_pipeline(left, right, self.cfg, mesh=self.mesh)
        T_wc = (se3.identity(device=disp.device) if T_wc is None
                else T_wc.to(device=disp.device, dtype=torch.float32))
        d3d = depth_mod.depth_from_disparity_vbo(disp, self.K, self.baseline,
                                                 min_disp=self.min_disp)
        if self.do_plane:
            self._fit_plane(d3d, reset=self.z is None)
        if self.do_heightmap:
            if not self.hm_initialised:
                self.hm = self._make_heightmap(T_wc)
                self.hm_initialised = True
            pts_w = torch.cat([se3.transform(T_wc, d3d[..., :3]), d3d[..., 3:4]], dim=-1)
            self.hm.fuse(pts_w, image)
        return disp, d3d


def state_from_numpy(app: Stereo2App, z, n_c, hm, T_hw, initialised: bool,
                     device="cuda") -> Stereo2App:
    """Give ``app`` the state of the JAX package's ``Stereo2App`` from NumPy
    arrays: the plane (z, n_c; None before the first frame), the heightmap
    grid and its scaled world -> grid transform (None without a heightmap)
    and whether the grid is laid; on ``device``. Returns ``app``."""
    def f32(a):
        return None if a is None else torch.from_numpy(np.array(a, np.float32)).to(device)

    app.z, app.n_c = f32(z), f32(n_c)
    if hm is not None:
        fusion = HeightmapFusion(app.hm_size[0], app.hm_size[1], app.hm_cell, device=device)
        fusion.hm, fusion.T_hw = f32(hm), f32(T_hw)
        fusion.h, fusion.w = fusion.hm.shape[:2]
        app.hm = fusion
    app.hm_initialised = bool(initialised)
    return app
