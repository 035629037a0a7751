"""KinectFusion: dense TSDF SLAM (``kangaroo_tpu/apps/kinectfusion.py``).

Per frame: depth -> masked bilateral -> NaN-aware pyramid -> point and
normal images; a model raycast per ICP level; multi-level projective
point-plane ICP; the gated pose update; the TSDF fuse, with the colour
volume under ``use_colour``. Three engines, as the JAX package's:

* 'separable' (the default): the plane sweep of ``fusion/separable.py``.
  The JAX package compiles the frame into one jit (``make_frame_step``)
  and a recorded sequence into one scan (``make_sequence_runner``); here
  the step is a plain function of tensors and the sequence a loop of it.
  On a CUDA tensor the depth-only fuse is the kernel of
  ``fusion/separable_cuda.py``, which the frame hands its own volume to
  update in place; the colour fuse is plain PyTorch on every device.
* 'guided': the coarse-to-fine raycast (``raycast_sdf_guided``, on levels
  whose size 4 divides) and the nearest-sample voxel fuse
  (``fusion/sdf.py``), in stages.
* 'exact': the reference's full sphere trace and bilinear voxel fuse.

The guided and exact engines associate ICP in a window of
``icp_assoc_radius`` pixels (their model lies on the pixel lattice) and
are plain PyTorch on every device. ``moving_threshold_voxels`` > 0 rolls
the volume (and the colour volume) to follow the camera before each
frame (``fusion/rolling.py``). Host reads per frame: the rmse (the
divergence gate), each sweep raycast's plane window and orientation test
and its 'auto' sweep axis, the fuse's axis under 'auto', one read every 8
march steps of the guided and exact raycasts, and the pose for the moving
workspace.

The output side runs on the host where the JAX package's does:
``save_mesh`` copies the volume to the host once and meshes it there
(``fusion/marching_cubes.py``, ``marching_cubes256.py``), and
``save_volume`` / ``load_volume`` go through ``io/pxm.py``.
``save_keyframe`` and ``render_textured`` texture a render from the last
10 saved keyframes on the app's device.

``mesh=`` (a ``parallel.mesh.Mesh``) runs the frame model-parallel, as the
JAX package's: the TSDF (and the colour volume) lives as z-slabs, slab k on
``mesh.devices[k]`` (``parallel.sharding.ZSlabs``); the frame step sweeps
the slabs (``sharded_raycast_separable``) and fuses each slab
(``sharded_sdf_fuse_separable``: on a card one fuse launch a slab), while
the image-space work (preprocess, ICP) runs on ``mesh.devices[0]``. It
needs the separable engine, ``raycast_downsample`` and a mesh that divides
``vol_res``. ``vol`` and ``color_vol`` read as whole volumes gathered onto
``mesh.devices[0]`` (a copy) and are cut into slabs when assigned, so the
rare readers and writers (render, save, load, the moving workspace's roll)
work as on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..backend import constant, f32_scalars
from ..containers import pyramid as pyr_mod
from ..containers.bbox import BoundingBox
from ..containers.intrinsics import Intrinsics
from ..containers.volume import BoundedVolume, TsdfVolume
from ..core import se3
from ..fusion import raycast as rc
from ..fusion import rolling
from ..fusion import sdf as sdf_mod
from ..fusion import separable
from ..geometry import depth as depth_mod
from ..ops import bilateral as bf
from ..parallel import sharding as sh
from ..parallel.mesh import Mesh
from ..solvers import icp as icp_mod
from ..solvers.lss import LSS

ENGINES = ("separable", "guided", "exact")


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
    if cfg.engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {cfg.engine!r}")
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a kangaroo_tpu_torch.parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if cfg.engine != "separable" or not cfg.raycast_downsample:
        raise ValueError("the mesh-parallel frame requires engine='separable' and "
                         "raycast_downsample=True (one sharded full-resolution sweep)")
    if cfg.vol_res % mesh.size:
        raise ValueError(f"the {mesh.size}-way mesh must divide vol_res={cfg.vol_res}")


def _app_device(device, mesh) -> torch.device:
    """The app's device: ``device`` (the card by default), or with a mesh
    its first device, which ``device`` must then name."""
    if mesh is None:
        return torch.device("cuda" if device is None else device)
    dev0 = mesh.devices[0]
    if device is not None:
        d = torch.device(device)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d != dev0:
            raise ValueError(f"device {d} differs from the mesh's first device {dev0}, where "
                             "the image-space work runs")
    return dev0


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
    current pose per level (with ``levels`` given, the levels of no ICP
    iteration are skipped). The separable engine sweeps each level on its
    pose's 'auto' axis (``cloud`` returns the sweep-grid camera-space
    clouds); the guided engine raycasts coarse to fine where 4 divides the
    level's size, the exact engine (and the guided one elsewhere) marches
    the whole image."""
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
        if cfg.engine == "separable" and cloud:
            d, v, n = separable.raycast_sdf_separable(
                vol, T_wl, Kl, w_l, h_l, cfg.near, cfg.far, trunc_dist=trunc, shade=False,
                output="cloud")
            out_d.append(d)
            out_v.append(v)
            out_n.append(n)
            continue
        if cfg.engine == "separable":
            d, n, _ = separable.raycast_sdf_separable(
                vol, T_wl, Kl, w_l, h_l, cfg.near, cfg.far, trunc_dist=trunc, shade=False)
        elif cfg.engine == "guided" and w_l % 4 == 0 and h_l % 4 == 0:
            d, n, _ = rc.raycast_sdf_guided(vol, T_wl, Kl, w_l, h_l, cfg.near, cfg.far,
                                            trunc_dist=trunc, subpix=True)
        else:
            d, n, _ = rc.raycast_sdf(vol, T_wl, Kl, w_l, h_l, cfg.near, cfg.far,
                                     trunc_dist=trunc, subpix=True)
        out_d.append(d)
        out_v.append(depth_mod.depth_to_vbo(d, Kl))
        out_n.append(n)
    return out_d, out_v, out_n


def icp_refine(kin_v, ray_v, ray_n, K: Intrinsics, cfg: KinectFusionConfig, K_mats=None,
               assoc_radius: int | None = None):
    """Multi-level projective point-plane ICP, coarse to fine. Returns
    (T_lp, rmse): the live-from-previous correction, applied as
    T_wl <- T_wl T_lp^-1, and the last iteration's rmse (a device scalar).
    ``K_mats`` are the per-level 3x3 intrinsics matrices (default: from
    ``K``); ``assoc_radius`` bounds the association window, valid only for
    a model on the live pixel lattice."""
    dev = kin_v[0].device
    if K_mats is None:
        K_mats = [K.level(l).matrix(dev) for l in range(cfg.max_levels)]
    T_lp = se3.identity(dev)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    c, prior = f32_scalars(dev, cfg.icp_c, cfg.motion_prior)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    for l in range(cfg.max_levels - 1, -1, -1):
        if cfg.its[l] == 0:
            continue
        Km = torch.as_tensor(K_mats[l], dtype=torch.float32, device=dev)
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


def _colour_camera(cfg: KinectFusionConfig, device="cuda"):
    """(T_cd, K_rgb): the rgb camera from the depth camera,
    SE3(I, (baseline, 0, 0))^-1, and its intrinsics; the colour fuse
    projects through T_iw = T_cd T_wl^-1."""
    b = float(np.float32(cfg.rgb_baseline_m))
    T_dc = constant(((1.0, 0.0, 0.0, b), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0)),
                    device=device)
    return se3.inverse(T_dc), Intrinsics.centered(cfg.rgb_focal, cfg.w, cfg.h)


def _roi(cfg: KinectFusionConfig):
    """The fuse's near/far plane crop."""
    return dict(near=cfg.near if cfg.fuse_roi else None, far=cfg.far if cfg.fuse_roi else None)


def make_frame_step(K: Intrinsics, cfg: KinectFusionConfig, bbox, trunc_dist: float, mesh=None,
                    sweep_axis: int | str = "auto"):
    """The whole frame as one function: preprocess -> model raycasts -> ICP
    -> gated pose update -> the plane-sweep fuse.

    Returns ``step(val, weight, T_wl, depth_raw, first, lo, hi) -> (val',
    weight', T_wl', rmse)``, or with ``cfg.use_colour``
    ``step(val, weight, cval, T_wl, depth_raw, rgb, first, lo, hi) ->
    (val', weight', cval', T_wl', rmse)`` (the colour fuse). ``first``
    (bool or bool tensor) skips the pose gate: frame 0, or the re-seed
    after a reset, fuses at the current pose. The tracking gate rides
    inside the fuse (no update -> exact passthrough). ``val``/``weight``
    (and ``cval``) are updated in place and returned. ``sweep_axis`` pins
    the fuse's sweep axis (0 z, 1 y, 2 x; the one full-resolution
    raycast's too under ``raycast_downsample``) or picks it per pose
    ('auto'); the per-level model raycasts pick their own, as in the JAX
    package. The model raycasts are the config's engine's, as there.

    With ``mesh`` (see :func:`_check_config`) ``val``, ``weight`` and
    ``cval`` are tuples of z-slabs (``parallel.sharding.ZSlabs``' fields),
    updated in place and returned; the full-resolution sweep and the fuse
    are their z-sharded versions on the z axis, whatever ``sweep_axis``
    says, and the rest runs on ``mesh.devices[0]``."""
    del bbox  # the bbox flows through as (lo, hi) arguments
    _check_config(cfg, mesh)
    pixel_lattice = cfg.raycast_downsample or cfg.engine != "separable"

    def body(val, weight, T_wl, depth_raw, first, lo, hi, cval=None, rgb=None):
        dev = T_wl.device
        _, kin_v, kin_n = preprocess_depth(depth_raw, K, cfg)
        bbox = BoundingBox(lo, hi)
        vol = (sh.ZSlabs(bbox, mesh, val=tuple(val), weight=tuple(weight)) if mesh is not None
               else TsdfVolume(val, weight, bbox))
        if cfg.engine == "separable" and cfg.raycast_downsample:
            # one full-resolution sweep; the coarser ICP levels from a
            # NaN-aware box downsampling of its depth
            if mesh is not None:
                d0, _, _ = sh.sharded_raycast_separable(vol, T_wl, K, cfg.w, cfg.h, mesh,
                                                        near=cfg.near, far=cfg.far,
                                                        trunc_dist=trunc_dist, shade=False)
            else:
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
                                            cloud=cfg.engine == "separable")
        T_lp, rmse = icp_refine(kin_v, ray_v, ray_n, K, cfg,
                                assoc_radius=cfg.icp_assoc_radius if pixel_lattice else None)
        if not isinstance(first, torch.Tensor):
            first = torch.full((), bool(first), dtype=torch.bool, device=dev)
        good = torch.isfinite(rmse) & (rmse < cfg.max_rmse)
        T_new = torch.where(good & ~first, se3.compose(T_wl, se3.inverse(T_lp)), T_wl)
        T_lw = se3.inverse(T_new)
        if cval is not None:
            T_cd, K_rgb = _colour_camera(cfg, dev)
            args = (kin_v[0][..., 2], kin_n[0], T_lw, K, rgb, se3.compose(T_cd, T_lw), K_rgb,
                    trunc_dist, cfg.max_w, cfg.min_cos_theta)
            if mesh is not None:
                fusedv, fusedc = sh.sharded_sdf_fuse_color_separable(
                    vol, sh.ZSlabs(bbox, mesh, data=tuple(cval)), *args, mesh,
                    enable=good | first, inplace=True, **_roi(cfg))
            else:
                fusedv, fusedc = separable.sdf_fuse_color_separable(
                    vol, BoundedVolume(cval, bbox), *args, enable=good | first,
                    sweep_axis=sweep_axis, inplace=True, **_roi(cfg))
            return fusedv.val, fusedv.weight, fusedc.data, T_new, rmse
        args = (kin_v[0][..., 2], kin_n[0], T_lw, K, trunc_dist, cfg.max_w, cfg.min_cos_theta)
        if mesh is not None:
            fused = sh.sharded_sdf_fuse_separable(vol, *args, mesh, enable=good | first,
                                                  inplace=True, **_roi(cfg))
        else:
            fused = separable.sdf_fuse_separable(vol, *args, enable=good | first,
                                                 sweep_axis=sweep_axis, inplace=True,
                                                 **_roi(cfg))
        return fused.val, fused.weight, T_new, rmse

    if cfg.use_colour:
        def step(val, weight, cval, T_wl, depth_raw, rgb, first, lo, hi):
            return body(val, weight, T_wl, depth_raw, first, lo, hi, cval=cval, rgb=rgb)
    else:
        def step(val, weight, T_wl, depth_raw, first, lo, hi):
            return body(val, weight, T_wl, depth_raw, first, lo, hi)
    return step


def make_sequence_runner(K: Intrinsics, cfg: KinectFusionConfig, trunc_dist: float, mesh=None,
                         sweep_axis: int | str = 0):
    """A recorded sequence through :func:`make_frame_step`, frame by frame:
    ``run(val, weight, T_wl, depths (N, H, W), firsts (N,), lo, hi) ->
    (val', weight', T_wl', poses (N, 3, 4), rmses (N,))``; with
    ``cfg.use_colour`` ``run(val, weight, cval, T_wl, depths, rgbs
    (N, H, W, 3), firsts, lo, hi) -> (val', weight', cval', T_wl', poses,
    rmses)``. ``sweep_axis`` is the axis of every frame (the JAX package's
    scan needs a static one)."""
    step = make_frame_step(K, cfg, None, trunc_dist, mesh=mesh, sweep_axis=sweep_axis)

    if cfg.use_colour:
        def run(val, weight, cval, T_wl, depths, rgbs, firsts, lo, hi):
            poses, rmses = [], []
            for depth, rgb, first in zip(depths, rgbs, firsts):
                val, weight, cval, T_wl, rmse = step(val, weight, cval, T_wl, depth, rgb, first,
                                                     lo, hi)
                poses.append(T_wl)
                rmses.append(rmse)
            return val, weight, cval, T_wl, torch.stack(poses), torch.stack(rmses)
        return run

    def run(val, weight, T_wl, depths, firsts, lo, hi):
        poses, rmses = [], []
        for depth, first in zip(depths, firsts):
            val, weight, T_wl, rmse = step(val, weight, T_wl, depth, first, lo, hi)
            poses.append(T_wl)
            rmses.append(rmse)
        return val, weight, T_wl, torch.stack(poses), torch.stack(rmses)

    return run


def state_from_numpy(val, weight, lo, hi, T_wl, device="cuda", color=None):
    """The port's state from NumPy arrays of the JAX package's (a volume's
    val and weight, its box corners, a pose): -> (TsdfVolume, T_wl), or
    with ``color`` (the colour volume's data, on the same box)
    -> (TsdfVolume, BoundedVolume, T_wl)."""
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)  # noqa: E731
    vol = TsdfVolume(f32(val), f32(weight), BoundingBox(f32(lo), f32(hi)))
    if color is None:
        return vol, f32(T_wl)
    return vol, BoundedVolume(f32(color), BoundingBox(f32(lo), f32(hi))), f32(T_wl)


class KinectFusion:
    """The app's main loop as a stateful object, on ``device`` (the card
    unless the caller asks for another), or with ``mesh`` model-parallel
    over its devices (see the module docstring)."""

    def __init__(self, K: Intrinsics, cfg: KinectFusionConfig = KinectFusionConfig(), mesh=None,
                 device=None):
        _check_config(cfg, mesh)
        self.K, self.cfg, self.mesh = K, cfg, mesh
        self.device = _app_device(device, mesh)
        e = cfg.vol_extent
        if cfg.front_volume:
            bb = BoundingBox.create((-e, -e, cfg.near), (e, e, cfg.near + 2 * e),
                                    device=self.device)
        else:
            bb = BoundingBox.create((-e,) * 3, (e,) * 3, device=self.device)
        self.vol, self.color_vol = self._fresh_volumes(bb)
        if cfg.use_colour:
            self.T_cd, self.K_rgb = _colour_camera(cfg, self.device)
        self.T_wl = se3.identity(self.device)
        self.keyframes = []  # (img, K, T_iw) for view-dependent texturing
        self.frame = 0
        self.tracking_good = True
        self.rmse = 0.0
        self._step = None  # the frame step, built at first use
        self._seq_run = None  # the sequence runner and its sweep axis
        self._seq_axis = None

    @property
    def vol(self) -> TsdfVolume:
        """The TSDF; with a mesh its slabs gathered onto ``mesh.devices[0]``
        (a copy: write through the setter)."""
        return self._vol.gather() if self.mesh is not None else self._vol

    @vol.setter
    def vol(self, vol: TsdfVolume) -> None:
        self._vol = sh.shard_volume_z(vol, self.mesh) if self.mesh is not None else vol

    @property
    def color_vol(self) -> Optional[BoundedVolume]:
        """The colour volume (None without ``use_colour``), gathered as
        :attr:`vol` is."""
        if self.mesh is None or self._color is None:
            return self._color
        return self._color.gather()

    @color_vol.setter
    def color_vol(self, cvol: Optional[BoundedVolume]) -> None:
        self._color = (sh.shard_bounded_volume_z(cvol, self.mesh)
                       if self.mesh is not None and cvol is not None else cvol)

    def _set_state(self, val, weight, cval, bbox) -> None:
        """Replace the volumes by the frame step's outputs: tensors, or with a
        mesh tuples of slabs."""
        if self.mesh is not None:
            self._vol = sh.ZSlabs(bbox, self.mesh, val=tuple(val), weight=tuple(weight))
            if cval is not None:
                self._color = sh.ZSlabs(self._color.bbox, self.mesh, data=tuple(cval))
        else:
            self._vol = TsdfVolume(val, weight, bbox)
            if cval is not None:
                self._color = BoundedVolume(cval, self._color.bbox)

    def _fresh_volumes(self, bb, cbb=None, shape=None):
        """(NaN-reset TSDF, colour volume filled with 0.5 or None) of the
        config's cube, or of ``shape`` (D, H, W), as whole volumes."""
        d, h, w = shape if shape is not None else (self.cfg.vol_res,) * 3
        vol = TsdfVolume.create(w, h, d, bb, trunc_dist=math.nan)
        cvol = None
        if self.cfg.use_colour:
            cvol = BoundedVolume.create(w, h, d, cbb if cbb is not None else bb, fill=0.5)
        return vol, cvol

    @property
    def trunc_dist(self) -> float:
        return self.cfg.trunc_dist_factor * float(np.linalg.norm(
            self._vol.voxel_size_units().cpu().numpy()))

    def reset(self, T_wl=None):
        """NaN-reset the TSDF, refill the colour volume with 0.5 and go back to
        the identity pose (or ``T_wl``)."""
        self.vol, self.color_vol = self._fresh_volumes(
            self._vol.bbox, cbb=self._color.bbox if self._color is not None else None,
            shape=tuple(self._vol.shape if self.mesh is not None else self._vol.val.shape))
        self.T_wl = (se3.identity(self.device) if T_wl is None
                     else torch.as_tensor(T_wl, dtype=torch.float32, device=self.device))
        self.keyframes.clear()
        self.frame = 0
        self.tracking_good = True

    def _one_step_frame(self, depth_raw, rgb=None):
        """The whole frame through the step (with the colour volume under
        ``use_colour``); only the rmse is read on the host."""
        colour = self.cfg.use_colour
        if self._step is None:
            self._step = make_frame_step(self.K, self.cfg, self._vol.bbox, self.trunc_dist,
                                         mesh=self.mesh)
        bbox = self._vol.bbox

        def call(first):
            if colour:
                return self._step(self._vol.val, self._vol.weight, self._color.data, self.T_wl,
                                  depth_raw, rgb, first, bbox.lo, bbox.hi)
            out = self._step(self._vol.val, self._vol.weight, self.T_wl, depth_raw, first,
                             bbox.lo, bbox.hi)
            return out[:2] + (None,) + out[2:]

        val, w, cval, T_new, rmse = call(self.frame == 0)
        self.rmse = float(rmse) if self.frame > 0 else 0.0
        if self.frame > 0 and not np.isfinite(self.rmse):
            # divergence: the gate kept the volume; reset and re-seed from
            # the current frame
            self.reset()
            val, w, cval, T_new, _ = call(True)
        else:
            self.tracking_good = self.frame == 0 or self.rmse < self.cfg.max_rmse
        self._set_state(val, w, cval, bbox)
        self.T_wl = T_new
        self.frame += 1
        return self.T_wl

    def run_sequence(self, depths, rgbs=None):
        """Process a stacked (N, H, W) recorded sequence through the frame
        step (with stacked (N, H, W, 3) ``rgbs`` under ``use_colour``);
        returns (poses (N, 3, 4), rmses (N,)) and leaves the pipeline at the
        last frame. The sweep axis is the seed pose's for the whole
        sequence (z under a mesh), and neither the divergence reset nor the moving workspace
        fires mid-sequence, as in the JAX package's scan replay. The
        separable engine only, as there."""
        cfg = self.cfg
        if cfg.engine != "separable":
            raise ValueError("run_sequence requires the separable engine's frame step")
        if cfg.use_colour and rgbs is None:
            raise ValueError("use_colour requires stacked rgbs")
        if rgbs is not None and not cfg.use_colour:
            raise ValueError("rgbs passed but the config has use_colour=False; they would be "
                             "ignored")
        depths = torch.as_tensor(depths, device=self.device)
        n = depths.shape[0]
        axis = (0 if self.mesh is not None
                else separable._view_axis_index(se3.inverse(self.T_wl)))
        if self._seq_run is None or self._seq_axis != axis:
            self._seq_run = make_sequence_runner(self.K, cfg, self.trunc_dist, mesh=self.mesh,
                                                 sweep_axis=axis)
            self._seq_axis = axis
        was_first = self.frame == 0
        firsts = [i == 0 and was_first for i in range(n)]
        bbox = self._vol.bbox
        if cfg.use_colour:
            val, w, cval, T_wl, poses, rmses = self._seq_run(
                self._vol.val, self._vol.weight, self._color.data, self.T_wl, depths,
                torch.as_tensor(rgbs, device=self.device), firsts, bbox.lo, bbox.hi)
        else:
            cval = None
            val, w, T_wl, poses, rmses = self._seq_run(self._vol.val, self._vol.weight,
                                                       self.T_wl, depths, firsts, bbox.lo,
                                                       bbox.hi)
        self._set_state(val, w, cval, bbox)
        self.T_wl = T_wl
        self.frame += n
        if was_first and n == 1:
            # frame 0's ICP ran against an empty model; its rmse means nothing
            self.rmse, self.tracking_good = 0.0, True
        else:
            self.rmse = float(rmses[-1])
            self.tracking_good = bool(np.isfinite(self.rmse) and self.rmse < cfg.max_rmse)
        return poses, rmses

    def _maybe_roll(self):
        """The moving workspace: roll the volume (and the colour volume, by
        the same shift) by whole voxels when the camera's look-at point has
        drifted past the threshold. Opt-in: one host read of the pose a
        frame."""
        cfg = self.cfg
        if cfg.moving_threshold_voxels <= 0 or self.frame == 0:
            return
        shift = rolling.recenter_shift(self._vol, self.T_wl, lead=cfg.moving_lead_m,
                                       threshold_voxels=cfg.moving_threshold_voxels)
        if shift == (0, 0, 0):
            return
        self.vol = rolling.roll_volume(self.vol, shift)
        if self._color is not None:
            self.color_vol = rolling.roll_bounded_volume(self.color_vol, shift)

    def process_frame(self, depth_raw, rgb=None, fuse: bool = True,
                      pose_refinement: bool = True):
        """One iteration of the main loop; returns the new pose T_wl. ``rgb``
        (H, W, 3) fuses colour when the config has ``use_colour``."""
        cfg = self.cfg
        self._maybe_roll()
        depth_raw = torch.as_tensor(depth_raw, device=self.device)
        if rgb is not None:
            rgb = torch.as_tensor(rgb, device=self.device)
        if (cfg.engine == "separable" and fuse and pose_refinement
                and (rgb is None) == (not cfg.use_colour)):
            # the whole frame through the step: depth only, or colour with an
            # rgb frame
            return self._one_step_frame(depth_raw, rgb=rgb)
        _, kin_v, kin_n = preprocess_depth(depth_raw, self.K, cfg)
        if pose_refinement and self.frame > 0:
            _, ray_v, ray_n = raycast_model(self.vol, self.T_wl, self.K, cfg, levels=cfg.its,
                                            cloud=cfg.engine == "separable")
            pixel_lattice = cfg.raycast_downsample or cfg.engine != "separable"
            T_lp, rmse = icp_refine(kin_v, ray_v, ray_n, self.K, cfg,
                                    assoc_radius=cfg.icp_assoc_radius if pixel_lattice else None)
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
            T_lw = se3.inverse(self.T_wl)
            depth = kin_v[0][..., 2]
            if cfg.use_colour and rgb is not None:
                T_iw = se3.compose(self.T_cd, T_lw)
                if cfg.engine == "separable":
                    self.vol, self.color_vol = separable.sdf_fuse_color_separable(
                        self.vol, self.color_vol, depth, kin_n[0], T_lw, self.K, rgb, T_iw,
                        self.K_rgb, self.trunc_dist, cfg.max_w, cfg.min_cos_theta, **_roi(cfg))
                else:
                    self.vol, self.color_vol = sdf_mod.sdf_fuse_color(
                        self.vol, self.color_vol, depth, kin_n[0], T_lw, self.K, rgb, T_iw,
                        self.K_rgb, self.trunc_dist, cfg.max_w, cfg.min_cos_theta)
            elif cfg.engine == "separable":
                self.vol = separable.sdf_fuse_separable(
                    self.vol, depth, kin_n[0], T_lw, self.K, self.trunc_dist, cfg.max_w,
                    cfg.min_cos_theta, **_roi(cfg))
            else:
                self.vol = sdf_mod.sdf_fuse(
                    self.vol, depth, kin_n[0], T_lw, self.K, self.trunc_dist, cfg.max_w,
                    cfg.min_cos_theta, sample="nearest" if cfg.engine == "guided" else "bilinear")
        self.frame += 1
        return self.T_wl

    def render(self, T_wc=None, level: int = 0, show_colour: bool = False):
        """View-only raycast: (depth, normals, image); the image is Phong
        shading, or the colour volume's grey with ``show_colour`` (under
        ``use_colour``), which takes the guided raycast (the exact one on
        the exact engine or where 4 does not divide the size)."""
        cfg = self.cfg
        T = self.T_wl if T_wc is None else torch.as_tensor(T_wc, dtype=torch.float32,
                                                            device=self.device)
        Kl = self.K.level(level)
        w_l, h_l = cfg.w >> level, cfg.h >> level
        cvol = self.color_vol if show_colour and cfg.use_colour else None
        if cfg.engine == "separable" and cvol is None:
            return separable.raycast_sdf_separable(self.vol, T, Kl, w_l, h_l, cfg.near, cfg.far,
                                                   trunc_dist=self.trunc_dist)
        if cfg.engine != "exact" and w_l % 4 == 0 and h_l % 4 == 0:
            return rc.raycast_sdf_guided(self.vol, T, Kl, w_l, h_l, cfg.near, cfg.far,
                                         trunc_dist=self.trunc_dist, color_vol=cvol)
        return rc.raycast_sdf(self.vol, T, Kl, w_l, h_l, cfg.near, cfg.far,
                              trunc_dist=self.trunc_dist, color_vol=cvol)

    def save_keyframe(self, img, K_kf=None):
        """Store the current camera image and pose for view-dependent
        texturing: T_iw = T_cd T_wl^-1 under ``use_colour`` (the colour
        camera's world-to-image transform), else T_wl^-1. ``K_kf`` defaults
        to the colour intrinsics under ``use_colour``, else the depth
        camera's."""
        if K_kf is None:
            K_kf = self.K_rgb if self.cfg.use_colour else self.K
        T_lw = se3.inverse(self.T_wl)
        T_iw = se3.compose(self.T_cd, T_lw) if self.cfg.use_colour else T_lw
        self.keyframes.append((torch.as_tensor(img, device=self.device), K_kf, T_iw))

    def render_textured(self, T_wc=None, level: int = 0):
        """View-only render textured from the saved keyframes: the raycast's
        depth, normals and Phong shading, then the last 10 keyframes blended
        by view alignment, the shading where none sees the surface.
        Returns (depth, normals, rgba); without keyframes the rgba is the
        grey shading with alpha 1."""
        d, n, phong = self.render(T_wc, level)
        if not self.keyframes:
            rgba = torch.cat([phong[..., None].repeat_interleave(3, dim=-1),
                              torch.ones_like(phong)[..., None]], dim=-1)
            return d, n, rgba
        T_wd = self.T_wl if T_wc is None else torch.as_tensor(T_wc, dtype=torch.float32,
                                                               device=self.device)
        rgba = depth_mod.texture_depth_keyframes(d, n, phong, self.keyframes[-10:], T_wd,
                                                 self.K.level(level))
        return d, n, rgba

    def save_mesh(self, path: str, method: str = "tet"):
        """Mesh the TSDF into a binary PLY at ``path`` and return the
        triangles ((n, 3, 3) float32 NumPy): ``method="tet"`` by marching
        tetrahedra, ``"mc"`` by the classic 256-case tables (about a third
        of the triangles). Unobserved (non-finite) values count as
        ``trunc_dist``; the volume is copied to the host once."""
        from ..fusion import marching_cubes as mc
        from ..fusion import marching_cubes256 as mc256

        if method not in ("tet", "mc"):
            raise ValueError(f"save_mesh: method must be 'tet' or 'mc', got {method!r}")
        vol = self.vol
        vol = TsdfVolume(torch.where(torch.isfinite(vol.val), vol.val, self.trunc_dist),
                         vol.weight, vol.bbox)
        tris = (mc256 if method == "mc" else mc).extract_mesh(vol)
        mc.save_ply(path, tris)
        return tris

    def save_volume(self, path: str):
        """Write the TSDF as a PXM volume with its box beside it
        (``io/pxm.save_tsdf``)."""
        from ..io import pxm

        pxm.save_tsdf(path, self.vol)

    def load_volume(self, path: str):
        """Load a TSDF saved by :meth:`save_volume` onto the app's device; the
        frame step is rebuilt for its box at the next frame."""
        from ..io import pxm

        self.vol = pxm.load_tsdf(path, device=self.device)
        self._step = self._seq_run = self._seq_axis = None
