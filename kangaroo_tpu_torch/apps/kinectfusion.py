"""KinectFusion: dense TSDF SLAM on the plane-sweep engine
(``kangaroo_tpu/apps/kinectfusion.py``).

Per frame: depth -> masked bilateral -> NaN-aware pyramid -> point and
normal images; a model raycast per ICP level; multi-level projective
point-plane ICP; the gated pose update; the TSDF fuse. The JAX package
compiles the frame into one jit (``make_frame_step``) and a recorded
sequence into one scan (``make_sequence_runner``); here the step is a plain
function of tensors and the sequence a loop of it. On a CUDA tensor the
fuse is the kernel of ``fusion/separable_cuda.py``, which the frame hands
its own volume to update in place (``KinectFusion`` replaces its volume
every frame anyway); everything else is plain PyTorch. Host reads per
frame: the rmse (the divergence gate), each model raycast's plane window
and orientation test and its 'auto' sweep axis, and the fuse's axis under
``sweep_axis='auto'``.

Ported: ``KinectFusionConfig`` (+ ``from_dict``), ``preprocess_depth``,
``raycast_model``, ``icp_refine``, ``make_frame_step``,
``make_sequence_runner`` and ``KinectFusion`` (``reset``,
``process_frame``, ``run_sequence``, ``render``) on the separable engine,
and :func:`state_from_numpy` to start from the JAX package's state. Not
ported yet, and refused with ``NotImplementedError`` (ROADMAP Queue 1,
KinectFusion leftovers): the 'exact' and 'guided' engines, colour fusion
(``use_colour``), ``mesh=`` (model-parallel), the moving workspace
(``moving_threshold_voxels > 0``), and meshing, volume I/O and keyframe
texturing (``save_mesh``, ``save_volume``, ``load_volume``,
``save_keyframe``, ``render_textured``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..backend import f32_scalars
from ..containers import pyramid as pyr_mod
from ..containers.bbox import BoundingBox
from ..containers.intrinsics import Intrinsics
from ..containers.volume import TsdfVolume
from ..core import se3
from ..fusion import separable
from ..geometry import depth as depth_mod
from ..ops import bilateral as bf
from ..solvers import icp as icp_mod
from ..solvers.lss import LSS

_TODO = "is not ported yet (ROADMAP Queue 1, KinectFusion leftovers)"


@dataclasses.dataclass
class KinectFusionConfig:
    """The same fields and defaults as ``kangaroo_tpu.apps.kinectfusion.KinectFusionConfig``."""

    w: int = 640
    h: int = 480
    vol_res: int = 256
    vol_extent: float = 1.0
    front_volume: bool = False
    max_levels: int = 4
    its: tuple = (1, 0, 2, 3)  # ICP iterations per level, fine -> coarse
    bilateral_size: int = 3
    bilateral_gs: float = 1.5
    bilateral_gr: float = 0.1
    bilateral_minval: float = 0.2
    icp_c: float = 0.1
    icp_assoc_radius: int | None = 4
    trunc_dist_factor: float = 2.0
    max_w: float = 1000.0
    min_cos_theta: float = 0.1
    max_rmse: float = 0.10
    near: float = 0.1
    far: float = 4.0
    fuse_roi: bool = True
    motion_prior: float = 0.1 / 0.2
    depth_scale: float = 1.0
    engine: str = "separable"
    raycast_downsample: bool = False
    moving_threshold_voxels: int = 0
    moving_lead_m: float = 0.5
    use_colour: bool = False
    rgb_focal: float = 535.7
    rgb_baseline_m: float = 0.08

    @classmethod
    def from_dict(cls, d: dict) -> "KinectFusionConfig":
        """A config from ``dataclasses.asdict`` of either package's config."""
        d = dict(d)
        d["its"] = tuple(d.get("its", cls.its))
        return cls(**d)


def _check_config(cfg: KinectFusionConfig, mesh=None) -> None:
    if mesh is not None:
        raise NotImplementedError(f"KinectFusion mesh= (model-parallel frames) {_TODO}")
    if cfg.engine != "separable":
        raise NotImplementedError(f"KinectFusion engine={cfg.engine!r} {_TODO}; "
                                  "engine='separable' runs")
    if cfg.use_colour:
        raise NotImplementedError(f"KinectFusion use_colour (colour fusion) {_TODO}")
    if cfg.moving_threshold_voxels > 0:
        raise NotImplementedError(f"KinectFusion moving_threshold_voxels > 0 (the moving "
                                  f"workspace) {_TODO}")


def preprocess_depth(depth_raw: torch.Tensor, K: Intrinsics, cfg: KinectFusionConfig):
    """Scale -> masked bilateral -> NaN-aware pyramid -> points and normals.
    Returns (depth_pyr, vbo_pyr, normal_pyr)."""
    meters = depth_raw.to(torch.float32) * cfg.depth_scale
    filtered = bf.bilateral_above_min(meters, cfg.bilateral_gs, cfg.bilateral_gr,
                                      cfg.bilateral_size, cfg.bilateral_minval)
    d_pyr = pyr_mod.box_reduce_ignore_invalid(filtered, cfg.max_levels)
    v_pyr = tuple(depth_mod.depth_to_vbo(d, K.level(l)) for l, d in enumerate(d_pyr))
    return d_pyr, v_pyr, tuple(depth_mod.normals_from_vbo(v) for v in v_pyr)


def raycast_model(vol: TsdfVolume, T_wl, K: Intrinsics, cfg: KinectFusionConfig,
                  levels: Optional[tuple] = None, trunc: Optional[float] = None,
                  cloud: bool = False):
    """Predicted depth/point/normal pyramids: a raycast of the model from the
    current pose per level, each on its pose's 'auto' sweep axis (with
    ``levels`` given, the levels of no ICP iteration are skipped). ``cloud``
    returns the sweep-grid camera-space clouds."""
    if trunc is None:
        trunc = cfg.trunc_dist_factor * float(np.linalg.norm(
            vol.voxel_size_units().cpu().numpy()))
    out_d, out_v, out_n = [], [], []
    for l in range(cfg.max_levels):
        if levels is not None and cfg.its[l] == 0:
            out_d.append(None)
            out_v.append(None)
            out_n.append(None)
            continue
        Kl = K.level(l)
        w_l, h_l = cfg.w >> l, cfg.h >> l
        if cloud:
            d, v, n = separable.raycast_sdf_separable(
                vol, T_wl, Kl, w_l, h_l, cfg.near, cfg.far, trunc_dist=trunc, shade=False,
                output="cloud")
        else:
            d, n, _ = separable.raycast_sdf_separable(
                vol, T_wl, Kl, w_l, h_l, cfg.near, cfg.far, trunc_dist=trunc, shade=False)
            v = depth_mod.depth_to_vbo(d, Kl)
        out_d.append(d)
        out_v.append(v)
        out_n.append(n)
    return out_d, out_v, out_n


def icp_refine(kin_v, ray_v, ray_n, K: Intrinsics, cfg: KinectFusionConfig,
               assoc_radius: int | None = None):
    """Multi-level projective point-plane ICP, coarse to fine. Returns
    (T_lp, rmse): the live-from-previous correction, applied as
    T_wl <- T_wl T_lp^-1, and the last iteration's rmse (a device scalar)."""
    dev = kin_v[0].device
    T_lp = se3.identity(dev)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    c, prior = f32_scalars(dev, cfg.icp_c, cfg.motion_prior)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    for l in range(cfg.max_levels - 1, -1, -1):
        if cfg.its[l] == 0:
            continue
        Kl = K.level(l)
        Km = Kl.matrix(dev)
        K_live = (Km[0, 0], Km[1, 1], Km[0, 2], Km[1, 2])
        for _ in range(cfg.its[l]):
            s = icp_mod.icp_point_plane(kin_v[l], ray_v[l], ray_n[l], Km @ T_lp,
                                        se3.inverse(T_lp), c, assoc_radius=assoc_radius,
                                        K_live=K_live)
            s_prior = LSS(s.JTJ + prior * eye6, s.JTy, s.sqErr, s.obs)
            rmse = s.rmse()
            x = -icp_mod.solve_pose_update(
                s_prior, rotation_only=l == cfg.max_levels - 1 and cfg.max_levels > 1)
            x = torch.where(torch.isfinite(x), x, 0.0)
            T_lp = se3.compose(T_lp, se3.exp(x))
    return T_lp, rmse


def make_frame_step(K: Intrinsics, cfg: KinectFusionConfig, bbox, trunc_dist: float, mesh=None,
                    sweep_axis: int | str = "auto"):
    """The whole frame as one function: preprocess -> model raycasts -> ICP
    -> gated pose update -> fuse.

    Returns ``step(val, weight, T_wl, depth_raw, first, lo, hi) -> (val',
    weight', T_wl', rmse)``. ``first`` (bool or bool tensor) skips the pose
    gate: frame 0, or the re-seed after a reset, fuses at the current pose.
    The tracking gate rides inside the fuse (no update -> exact
    passthrough). ``val``/``weight`` are updated in place and returned.
    ``sweep_axis`` pins the fuse's sweep axis (0 z, 1 y, 2 x; the one
    full-resolution raycast's too under ``raycast_downsample``) or picks it
    per pose ('auto'); the per-level model raycasts pick their own, as in
    the JAX package."""
    del bbox  # the bbox flows through as (lo, hi) arguments
    _check_config(cfg, mesh)

    def step(val, weight, T_wl, depth_raw, first, lo, hi):
        dev = val.device
        _, kin_v, kin_n = preprocess_depth(depth_raw, K, cfg)
        vol = TsdfVolume(val, weight, BoundingBox(lo, hi))
        if cfg.raycast_downsample:
            # one full-resolution sweep; the coarser ICP levels from a
            # NaN-aware box downsampling of its depth
            d0, _, _ = separable.raycast_sdf_separable(
                vol, T_wl, K, cfg.w, cfg.h, cfg.near, cfg.far, trunc_dist=trunc_dist,
                shade=False, sweep_axis=sweep_axis)
            d_pyr = pyr_mod.box_reduce_ignore_invalid(d0, cfg.max_levels)
            ray_v, ray_n = [], []
            for l in range(cfg.max_levels):
                vl = (None if cfg.its[l] == 0
                      else depth_mod.depth_to_vbo(d_pyr[l], K.level(l)))
                ray_v.append(vl)
                ray_n.append(None if vl is None else depth_mod.normals_from_vbo(vl))
        else:
            _, ray_v, ray_n = raycast_model(vol, T_wl, K, cfg, levels=cfg.its, trunc=trunc_dist,
                                            cloud=True)
        T_lp, rmse = icp_refine(kin_v, ray_v, ray_n, K, cfg,
                                assoc_radius=cfg.icp_assoc_radius if cfg.raycast_downsample
                                else None)
        if not isinstance(first, torch.Tensor):
            first = torch.full((), bool(first), dtype=torch.bool, device=dev)
        good = torch.isfinite(rmse) & (rmse < cfg.max_rmse)
        T_new = torch.where(good & ~first, se3.compose(T_wl, se3.inverse(T_lp)), T_wl)
        fused = separable.sdf_fuse_separable(
            vol, kin_v[0][..., 2], kin_n[0], se3.inverse(T_new), K, trunc_dist, cfg.max_w,
            cfg.min_cos_theta, enable=good | first, sweep_axis=sweep_axis,
            near=cfg.near if cfg.fuse_roi else None, far=cfg.far if cfg.fuse_roi else None,
            inplace=True)
        return fused.val, fused.weight, T_new, rmse

    return step


def make_sequence_runner(K: Intrinsics, cfg: KinectFusionConfig, trunc_dist: float, mesh=None,
                         sweep_axis: int | str = 0):
    """A recorded sequence through :func:`make_frame_step`, frame by frame:
    ``run(val, weight, T_wl, depths (N, H, W), firsts (N,), lo, hi) ->
    (val', weight', T_wl', poses (N, 3, 4), rmses (N,))``. ``sweep_axis`` is
    the axis of every frame (the JAX package's scan needs a static one)."""
    step = make_frame_step(K, cfg, None, trunc_dist, mesh=mesh, sweep_axis=sweep_axis)

    def run(val, weight, T_wl, depths, firsts, lo, hi):
        poses, rmses = [], []
        for depth, first in zip(depths, firsts):
            val, weight, T_wl, rmse = step(val, weight, T_wl, depth, first, lo, hi)
            poses.append(T_wl)
            rmses.append(rmse)
        return val, weight, T_wl, torch.stack(poses), torch.stack(rmses)

    return run


def state_from_numpy(val, weight, lo, hi, T_wl, device="cuda"):
    """The port's state from NumPy arrays of the JAX package's (a volume's
    val and weight, its box corners, a pose): -> (TsdfVolume, T_wl)."""
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)  # noqa: E731
    return TsdfVolume(f32(val), f32(weight), BoundingBox(f32(lo), f32(hi))), f32(T_wl)


class KinectFusion:
    """The app's main loop as a stateful object, on ``device`` (the card
    unless the caller asks for another)."""

    def __init__(self, K: Intrinsics, cfg: KinectFusionConfig = KinectFusionConfig(), mesh=None,
                 device="cuda"):
        _check_config(cfg, mesh)
        self.K, self.cfg, self.mesh = K, cfg, mesh
        self.device = torch.device(device)
        e = cfg.vol_extent
        if cfg.front_volume:
            bb = BoundingBox.create((-e, -e, cfg.near), (e, e, cfg.near + 2 * e), device=device)
        else:
            bb = BoundingBox.create((-e,) * 3, (e,) * 3, device=device)
        self.vol = self._fresh_volume(bb)
        self.T_wl = se3.identity(self.device)
        self.frame = 0
        self.tracking_good = True
        self.rmse = 0.0
        self._step = None  # the frame step, built at first use
        self._seq_run = None  # the sequence runner and its sweep axis
        self._seq_axis = None

    def _fresh_volume(self, bb, shape=None) -> TsdfVolume:
        """A NaN-reset TSDF of the config's cube, or of ``shape`` (D, H, W)."""
        d, h, w = shape if shape is not None else (self.cfg.vol_res,) * 3
        return TsdfVolume.create(w, h, d, bb, trunc_dist=math.nan)

    @property
    def trunc_dist(self) -> float:
        return self.cfg.trunc_dist_factor * float(np.linalg.norm(
            self.vol.voxel_size_units().cpu().numpy()))

    def reset(self, T_wl=None):
        """NaN-reset the TSDF and go back to the identity pose (or ``T_wl``)."""
        self.vol = self._fresh_volume(self.vol.bbox, shape=tuple(self.vol.val.shape))
        self.T_wl = (se3.identity(self.device) if T_wl is None
                     else torch.as_tensor(T_wl, dtype=torch.float32, device=self.device))
        self.frame = 0
        self.tracking_good = True

    def _one_step_frame(self, depth_raw):
        """The whole frame through the step; only the rmse is read on the host."""
        if self._step is None:
            self._step = make_frame_step(self.K, self.cfg, self.vol.bbox, self.trunc_dist)
        bbox = self.vol.bbox
        val, w, T_new, rmse = self._step(self.vol.val, self.vol.weight, self.T_wl, depth_raw,
                                         self.frame == 0, bbox.lo, bbox.hi)
        self.rmse = float(rmse) if self.frame > 0 else 0.0
        if self.frame > 0 and not np.isfinite(self.rmse):
            # divergence: the gate kept the volume; reset and re-seed from
            # the current frame
            self.reset()
            val, w, T_new, _ = self._step(self.vol.val, self.vol.weight, self.T_wl, depth_raw,
                                          True, bbox.lo, bbox.hi)
        else:
            self.tracking_good = self.frame == 0 or self.rmse < self.cfg.max_rmse
        self.vol = TsdfVolume(val, w, bbox)
        self.T_wl = T_new
        self.frame += 1
        return self.T_wl

    def run_sequence(self, depths, rgbs=None):
        """Process a stacked (N, H, W) recorded sequence through the frame
        step; returns (poses (N, 3, 4), rmses (N,)) and leaves the pipeline at
        the last frame. The sweep axis is the seed pose's for the whole
        sequence, and the divergence reset does not fire mid-sequence, as in
        the JAX package's scan replay."""
        if rgbs is not None:
            raise NotImplementedError(f"run_sequence rgbs (colour fusion) {_TODO}")
        depths = torch.as_tensor(depths, device=self.device)
        n = depths.shape[0]
        axis = separable._view_axis_index(se3.inverse(self.T_wl))
        if self._seq_run is None or self._seq_axis != axis:
            self._seq_run = make_sequence_runner(self.K, self.cfg, self.trunc_dist,
                                                 sweep_axis=axis)
            self._seq_axis = axis
        was_first = self.frame == 0
        firsts = [i == 0 and was_first for i in range(n)]
        val, w, T_wl, poses, rmses = self._seq_run(self.vol.val, self.vol.weight, self.T_wl,
                                                   depths, firsts, self.vol.bbox.lo,
                                                   self.vol.bbox.hi)
        self.vol = TsdfVolume(val, w, self.vol.bbox)
        self.T_wl = T_wl
        self.frame += n
        if was_first and n == 1:
            # frame 0's ICP ran against an empty model; its rmse means nothing
            self.rmse, self.tracking_good = 0.0, True
        else:
            self.rmse = float(rmses[-1])
            self.tracking_good = bool(np.isfinite(self.rmse) and self.rmse < self.cfg.max_rmse)
        return poses, rmses

    def process_frame(self, depth_raw, rgb=None, fuse: bool = True,
                      pose_refinement: bool = True):
        """One iteration of the main loop; returns the new pose T_wl."""
        cfg = self.cfg
        if rgb is not None:
            raise NotImplementedError(f"process_frame rgb (colour fusion) {_TODO}")
        depth_raw = torch.as_tensor(depth_raw, device=self.device)
        if fuse and pose_refinement:
            return self._one_step_frame(depth_raw)
        _, kin_v, kin_n = preprocess_depth(depth_raw, self.K, cfg)
        if pose_refinement and self.frame > 0:
            _, ray_v, ray_n = raycast_model(self.vol, self.T_wl, self.K, cfg, levels=cfg.its,
                                            cloud=True)
            # as the JAX package: the window association under
            # raycast_downsample, though the model here is the sweep cloud
            T_lp, rmse = icp_refine(kin_v, ray_v, ray_n, self.K, cfg,
                                    assoc_radius=cfg.icp_assoc_radius if cfg.raycast_downsample
                                    else None)
            self.rmse = float(rmse)
            if not np.isfinite(self.rmse):
                # divergence: reset and fuse the current frame into the
                # fresh volume
                self.reset()
            else:
                self.tracking_good = self.rmse < cfg.max_rmse
                if self.tracking_good:
                    self.T_wl = se3.compose(self.T_wl, se3.inverse(T_lp))
        if fuse and self.tracking_good:
            self.vol = separable.sdf_fuse_separable(
                self.vol, kin_v[0][..., 2], kin_n[0], se3.inverse(self.T_wl), self.K,
                self.trunc_dist, cfg.max_w, cfg.min_cos_theta,
                near=cfg.near if cfg.fuse_roi else None, far=cfg.far if cfg.fuse_roi else None)
        self.frame += 1
        return self.T_wl

    def render(self, T_wc=None, level: int = 0, show_colour: bool = False):
        """View-only raycast: (depth, normals, Phong image)."""
        if show_colour:
            raise NotImplementedError(f"render show_colour (colour fusion) {_TODO}")
        cfg = self.cfg
        T = self.T_wl if T_wc is None else torch.as_tensor(T_wc, dtype=torch.float32,
                                                            device=self.device)
        return separable.raycast_sdf_separable(self.vol, T, self.K.level(level), cfg.w >> level,
                                               cfg.h >> level, cfg.near, cfg.far,
                                               trunc_dist=self.trunc_dist)

    def _not_ported(self, what):
        raise NotImplementedError(f"KinectFusion.{what} (meshing, volume I/O and keyframe "
                                  f"texturing) {_TODO}")

    def save_keyframe(self, img, K_kf=None):
        self._not_ported("save_keyframe")

    def render_textured(self, T_wc=None, level: int = 0):
        self._not_ported("render_textured")

    def save_mesh(self, path: str, method: str = "tet"):
        self._not_ported("save_mesh")

    def save_volume(self, path: str):
        self._not_ported("save_volume")

    def load_volume(self, path: str):
        self._not_ported("load_volume")
