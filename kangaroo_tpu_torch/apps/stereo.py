"""Variational (DTAM-style) stereo (``kangaroo_tpu/apps/stereo.py``).

Preprocess -> census (or truncated abs-and-gradient) cost volume ->
optional guided filter -> the DTAM alternation (weighted-Huber dual ascent
on q, weighted primal descent on d, exhaustive auxiliary search with a
square penalty, theta annealing) or plain WTA -> median, LR check and
gradient filter. ``stereo_pipeline`` is the cold solve (with
``coarse_init``, warm-started from a half-size solve);
``VariationalStereo.process_frame`` the reference's incremental schedule,
5 iterations per frame from state carried across frames.
``MultiViewStereo`` accumulates posed views into a running-mean volume
(``stereo/costvolume.cost_volume_add``) and extracts disparity from it by
WTA or the alternation; ``depth_and_cloud`` and ``export_depthmap`` turn
disparity into depth, points and the app's depth-map files.

On a CUDA tensor the alternation runs in the DTAM kernel
(``stereo/dtam_cuda.py``, which launches the auxiliary-search kernel once
per iteration), the WTA initialisation, median and LR check in theirs; on a
CPU tensor every step is its plain version, :func:`dtam_iterate_plain`
being the transcription of the JAX package's XLA loop. ``stereo_pipeline``'s
``mesh`` runs the cold solve with the volume's disparity axis sharded
(``parallel.sharding.sharded_dtam_solve``, plain PyTorch on every device,
as the JAX package's sharded solve is XLA); the rest of the frame, and its
kernels, stay on the inputs' device.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..backend import f32_scalars
from ..core import se3
from ..geometry import depth as depth_mod
from ..io import pxm
from ..ops import integral_image as ii
from ..ops import resample as resample_mod
from ..parallel import sharding
from ..stereo import census as census_mod
from ..stereo import costvolume as cv
from ..stereo import dispatch as fast
from ..stereo import dtam_cuda
from ..utils import profiling
from ..variational import rof
from .stereo_sgm import _intensity


@dataclasses.dataclass
class StereoConfig:
    """The pipeline's parameters; the same fields and defaults as
    ``kangaroo_tpu.apps.stereo.StereoConfig``."""

    max_disp: int = 128
    census_window: str = "16x16"
    use_census: bool = True
    # DTAM
    theta_start: float = 100.0
    theta_end: float = 1e-4
    lam: float = 20.0
    sigma_q: float = 0.7
    sigma_d: float = 0.7
    huber_alpha: float = 0.002
    beta: float = 1e-5
    # edge weights
    g_alpha: float = 14.0
    g_beta: float = 2.5
    # box-mean subtract before the cost volume: img - boxmean(img) + 0.5
    avg_rad: int = 0
    # truncated abs-and-gradient cost mix (use_census=False)
    tag_alpha: float = 0.0
    tag_r1: float = 1e37
    tag_r2: float = 1e37
    # guided filter of the cost volume
    filter_volume: bool = False
    filter_rad: int = 9
    filter_eps: float = 1e-4
    # post
    lr_check: bool = True
    max_disp_diff: float = 1.0
    median_its: int = 1
    median_max_bad: int = 12
    filt_grad_thresh: float = 0.0
    dtam_iterations: int = 80
    # coarse-to-fine warm start: a half-size solve of coarse_iterations
    # steps, upsampled, initialises the dtam_iterations fine steps
    coarse_init: bool = False
    coarse_iterations: int = 50

    @classmethod
    def from_dict(cls, d: dict) -> "StereoConfig":
        """Build from ``dataclasses.asdict`` of a ``kangaroo_tpu`` StereoConfig."""
        return cls(**d)


def preprocess_intensity(img: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """[0, 1] intensity, then the optional re-centre
    img - boxmean(img, avg_rad) + 0.5."""
    f = _intensity(img)
    if cfg.avg_rad > 0:
        f = f - ii.box_filter(f, cfg.avg_rad) + 0.5
    return f


def cost_volume(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
                sd: int = -1) -> torch.Tensor:
    """Census volume (bfloat16 for a power-of-two normaliser and no volume
    filter, every cost k/bits being exact there; else float32) or, with
    ``use_census=False``, the truncated abs-and-gradient volume."""
    if cfg.use_census:
        cl = census_mod.census(left, cfg.census_window)
        cr = census_mod.census(right, cfg.census_window)
        bits = census_mod.norm_bits(cfg.census_window)
        dtype = (torch.bfloat16 if bits & (bits - 1) == 0 and not cfg.filter_volume
                 else torch.float32)
        if sd < 0:
            return census_mod.census_cost_volume(cl, cr, cfg.max_disp, -1, bits, dtype=dtype)
        return census_mod.census_cost_volume(cr, cl, cfg.max_disp, 1, bits, dtype=dtype)
    imgs = (left, right) if sd < 0 else (right, left)
    return cv.cost_volume_from_stereo_truncated_abs_and_grad(
        imgs[0].to(torch.float32), imgs[1].to(torch.float32), cfg.max_disp, sd,
        alpha=cfg.tag_alpha, r1=cfg.tag_r1, r2=cfg.tag_r2)


def dtam_iterate_plain(vol, g, d, a, q, theta, n0, lam, sigma_q, sigma_d, huber_alpha, beta,
                       iterations: int, sd: int = -1):
    """The plain version of the DTAM kernel, the JAX package's XLA loop
    transcribed: ``iterations`` steps from (d, a, q, theta), the i-th
    annealing theta <- theta (1 - beta (n0 + i)). The scalars are float32
    tensors on the volume's device. Returns (d, a, q, theta)."""
    lam, theta, sigma_q, sigma_d, huber_alpha, beta = f32_scalars(
        vol.device, lam, theta, sigma_q, sigma_d, huber_alpha, beta)
    for i in range(iterations):
        q = rof.weighted_huber_dual_ascent_p(q, d, g, sigma_q, huber_alpha)
        d = rof.weighted_l2_primal_descent(d, q, a, g, sigma_d, 1.0 / theta)
        a = cv.cost_vol_minimum_square_penalty_subpix(vol, d, lam, theta, sd)
        theta = theta * (1.0 - beta * (n0 + i))
    return d, a, q, theta


def _iterate(vol, g, d, a, q, theta, n0, lam, sigma_q, sigma_d, huber_alpha, beta,
             iterations: int, sd: int):
    """The alternation on the volume's device: plain on the CPU, else the
    kernel (which raises off an sm_90 card)."""
    run = dtam_iterate_plain if vol.device.type == "cpu" else dtam_cuda.dtam_run
    return run(vol, g, d, a, q, theta, n0, lam, sigma_q, sigma_d, huber_alpha, beta,
               iterations, sd)


def dtam_solve(vol, img_left, lam, theta_start, sigma_q, sigma_d, huber_alpha, beta, g_alpha,
               g_beta, iterations: int = 80, sd: int = -1, d_init=None) -> torch.Tensor:
    """The cold DTAM solve: the edge weight of ``img_left``, d = a = the
    WTA-subpixel disparity (or ``d_init``), q = 0, then ``iterations``
    steps annealing theta <- theta (1 - beta (n + 1)), n = 0, 1, ...
    Returns d, (H, W) float32."""
    g = cv.exponential_edge_weight(_intensity(img_left), g_alpha, g_beta)
    d0 = (d_init.to(torch.float32) if d_init is not None
          else fast.cost_vol_minimum_subpix(vol, sd))
    q0 = torch.zeros(d0.shape + (2,), dtype=torch.float32, device=d0.device)
    return _iterate(vol, g, d0, d0, q0, theta_start, 1.0, lam, sigma_q, sigma_d, huber_alpha,
                    beta, iterations, sd)[0]


def dtam_increment(vol, g, d, a, q, theta, n, lam, sigma_q, sigma_d, huber_alpha, beta,
                   iterations: int = 5, sd: int = -1):
    """Resume the alternation from (d, a, q, theta, n) for ``iterations``
    steps, theta <- theta (1 - beta n); n <- n + 1 with the global counter
    n. Returns the advanced (d, a, q, theta, n), theta and n float32 0-dim
    tensors."""
    d, a, q, theta = _iterate(vol, g, d, a, q, theta, n, lam, sigma_q, sigma_d, huber_alpha,
                              beta, iterations, sd)
    (n,) = f32_scalars(vol.device, n)
    return d, a, q, theta, n + float(iterations)


def postprocess(disp_l, disp_r, cfg: StereoConfig) -> torch.Tensor:
    """Median -> LR check -> gradient filter."""
    out = disp_l
    for _ in range(cfg.median_its):
        out = fast.median_filter_reject_invalid(out, cfg.median_max_bad, rad=2)
    if cfg.lr_check and disp_r is not None:
        out = fast.left_right_check(out, disp_r, -1, cfg.max_disp_diff, max_disp=cfg.max_disp)
    if cfg.filt_grad_thresh > 0:
        out = cv.filter_disp_grad(out, cfg.filt_grad_thresh)
    return out


def _volumes(left, right, cfg: StereoConfig):
    """The preprocessed left image and the (filtered) left volume."""
    left_p = preprocess_intensity(left, cfg)
    right_p = preprocess_intensity(right, cfg)
    vol_l = cost_volume(left_p, right_p, cfg, -1)
    if cfg.filter_volume:
        vol_l = ii.guided_filter_volume(vol_l, left_p, cfg.filter_rad, cfg.filter_eps)
    return left_p, right_p, vol_l


def _right_disparity(left_p, right_p, cfg: StereoConfig):
    if not cfg.lr_check:
        return None
    return fast.cost_vol_minimum_subpix(cost_volume(left_p, right_p, cfg, 1), 1)


def dtam_frame(left, right, state, cfg: StereoConfig, iterations: int = 5):
    """One incremental frame: preprocess, volume, ``iterations`` steps
    resumed from ``state`` = (d, a, q, theta, n) (None: the WTA-subpixel
    initialisation, q = 0, theta_start, n = 0), post filters. Returns
    (postprocessed disparity, new state)."""
    left_p, right_p, vol_l = _volumes(left, right, cfg)
    g = cv.exponential_edge_weight(left_p, cfg.g_alpha, cfg.g_beta)
    if state is None:
        d0 = fast.cost_vol_minimum_subpix(vol_l, -1)
        state = (d0, d0, torch.zeros(d0.shape + (2,), dtype=torch.float32, device=d0.device),
                 cfg.theta_start, 0.0)
    d, a, q, theta, n = state
    state = dtam_increment(vol_l, g, d, a, q, theta, n, cfg.lam, cfg.sigma_q, cfg.sigma_d,
                           cfg.huber_alpha, cfg.beta, iterations=iterations)
    return postprocess(state[0], _right_disparity(left_p, right_p, cfg), cfg), state


class VariationalStereo:
    """Stateful incremental DTAM stereo: ``reset()`` re-initialises from the
    next frame's WTA, ``process_frame()`` rebuilds the volume from the new
    pair and runs ``its_per_frame`` steps while theta > min_theta, then the
    post filters. The (d, a, q, theta, n) state persists across frames."""

    def __init__(self, cfg: StereoConfig = StereoConfig(), its_per_frame: int = 5,
                 min_theta: float = 1e-4):
        self.cfg = cfg
        self.its_per_frame = its_per_frame
        self.min_theta = float(min_theta)
        self.state = None
        self.disp = None

    def reset(self):
        """The next frame re-initialises from its volume's WTA."""
        self.state = None

    @property
    def theta(self):
        return float(self.state[3]) if self.state is not None else None

    @profiling.spanned("entry")
    def process_frame(self, left, right) -> torch.Tensor:
        """Run one frame; returns the postprocessed disparity."""
        its = self.its_per_frame
        if self.state is not None and self.theta <= self.min_theta:
            its = 0  # converged: the reference stops iterating
        self.disp, self.state = dtam_frame(left, right, self.state, self.cfg, its)
        return self.disp


def _coarse_disparity(left_p, right_p, cfg: StereoConfig) -> torch.Tensor:
    """The coarse-to-fine warm start: the DTAM solve of the 2x2 box-mean
    pair (max(max_disp / 2, 8) disparities, ``coarse_iterations`` steps),
    bilinearly upsampled to full size and doubled."""
    lh, rh = resample_mod.box_half(left_p), resample_mod.box_half(right_p)
    ccfg = dataclasses.replace(cfg, max_disp=max(cfg.max_disp // 2, 8), coarse_init=False)
    d_c = dtam_solve(cost_volume(lh, rh, ccfg, -1), lh, cfg.lam, cfg.theta_start, cfg.sigma_q,
                     cfg.sigma_d, cfg.huber_alpha, cfg.beta, cfg.g_alpha, cfg.g_beta,
                     iterations=cfg.coarse_iterations)
    H, W = left_p.shape
    return 2.0 * resample_mod.resample(d_c, W, H, "bilinear")


@profiling.spanned("entry")
def stereo_pipeline(left, right, cfg: StereoConfig = StereoConfig(), use_dtam: bool = True,
                    mesh=None) -> torch.Tensor:
    """Full frame for the left image of a rectified (H, W) pair:
    preprocess -> volume -> (guided filter) -> cold DTAM solve of
    ``cfg.dtam_iterations`` steps (from the upsampled half-size solve with
    ``cfg.coarse_init``), or WTA -> post. With ``mesh`` (a
    ``parallel.mesh.Mesh``) the DTAM solve is the disparity-sharded one,
    from the WTA as the JAX package's (``coarse_init`` does not apply); the
    mesh does nothing without ``use_dtam``. Returns float32 disparity with
    NaN invalids, on the inputs' device."""
    left_p, right_p, vol_l = _volumes(left, right, cfg)
    if use_dtam and mesh is not None:
        disp_l = sharding.sharded_dtam_solve(
            vol_l, left_p, cfg.lam, cfg.theta_start, cfg.sigma_q, cfg.sigma_d, cfg.huber_alpha,
            cfg.beta, cfg.g_alpha, cfg.g_beta, mesh,
            iterations=cfg.dtam_iterations).to(left_p.device)
    elif use_dtam:
        d_init = _coarse_disparity(left_p, right_p, cfg) if cfg.coarse_init else None
        disp_l = dtam_solve(vol_l, left_p, cfg.lam, cfg.theta_start, cfg.sigma_q, cfg.sigma_d,
                            cfg.huber_alpha, cfg.beta, cfg.g_alpha, cfg.g_beta,
                            iterations=cfg.dtam_iterations, d_init=d_init)
    else:
        disp_l = fast.cost_vol_minimum_subpix(vol_l, -1)
    return postprocess(disp_l, _right_disparity(left_p, right_p, cfg), cfg)


class MultiViewStereo:
    """Multi-frame cost-volume accumulation: anchor a keyframe, add posed
    views (T_wc (3, 4), camera to world) into its running-mean volume with
    ``cost_volume_add``, then extract disparity by WTA or the DTAM
    alternation. Runs on the keyframe's device."""

    def __init__(self, K, baseline: float, cfg: StereoConfig = StereoConfig(), rad: int = 1):
        self.K = K
        self.baseline = float(baseline)
        self.cfg = cfg
        self.rad = rad
        self.n = self.s = None
        self.img_v = None
        self.T_wv = None

    @profiling.spanned("entry")
    def reset(self, img_v: torch.Tensor, T_wv: torch.Tensor, right=None):
        """Anchor a new keyframe: an empty volume, or with ``right`` one seeded
        from the rectified pair, at the patch radius ``add`` uses (the
        running mean must average commensurate SAD magnitudes)."""
        H, W = img_v.shape
        self.img_v = img_v
        self.T_wv = T_wv.to(device=img_v.device, dtype=torch.float32)
        if right is None:
            self.n, self.s = cv.cost_volume_zero(self.cfg.max_disp, H, W, device=img_v.device)
        else:
            self.n, self.s = cv.cost_volume_from_stereo(img_v, right, self.cfg.max_disp, sd=-1,
                                                        rad=self.rad)

    @profiling.spanned("entry")
    def add(self, img_c: torch.Tensor, T_wc: torch.Tensor):
        """Accumulate one posed view: KT_cv = K (T_wc^-1 T_wv). Returns (n, s)."""
        if self.img_v is None:
            raise RuntimeError("MultiViewStereo.add: reset() a keyframe first")
        dev = self.img_v.device
        T_cv = se3.compose(se3.inverse(T_wc.to(device=dev, dtype=torch.float32)), self.T_wv)
        KT_cv = self.K.matrix(device=dev) @ T_cv
        self.n, self.s = cv.cost_volume_add(self.n, self.s, self.img_v, img_c, KT_cv, self.K,
                                            self.baseline, rad=self.rad)
        return self.n, self.s

    @profiling.spanned("entry")
    def volume(self) -> torch.Tensor:
        """The accumulated volume on the DTAM solver's cost scale: the running
        means over 255, clipped to [0, 1e6] (an empty cell's 1e30 becomes
        1e6)."""
        (scale,) = f32_scalars(self.n.device, 255.0)
        return torch.clamp(cv.cost_elem_to_float(self.n, self.s) / scale, 0.0, 1e6)

    @profiling.spanned("entry")
    def solve(self, use_dtam: bool = True) -> torch.Tensor:
        """Disparity of the accumulated :meth:`volume`: the cold DTAM solve on
        the keyframe as it is, or WTA + subpixel."""
        vol = self.volume()
        if use_dtam:
            cfg = self.cfg
            return dtam_solve(vol, self.img_v, cfg.lam, cfg.theta_start, cfg.sigma_q,
                              cfg.sigma_d, cfg.huber_alpha, cfg.beta, cfg.g_alpha, cfg.g_beta,
                              iterations=cfg.dtam_iterations)
        return fast.cost_vol_minimum_subpix(vol, -1)


def state_from_numpy(mvs: MultiViewStereo, n, s, img_v, T_wv, device="cuda") -> MultiViewStereo:
    """Give ``mvs`` the state (n, s, img_v, T_wv) from NumPy arrays of the
    JAX package's ``MultiViewStereo``, on ``device``; returns ``mvs``."""
    mvs.n, mvs.s, mvs.T_wv = (torch.from_numpy(np.array(a, np.float32)).to(device)
                              for a in (n, s, T_wv))
    mvs.img_v = torch.from_numpy(np.array(img_v)).to(device)
    return mvs


def depth_and_cloud(disp: torch.Tensor, K, baseline, min_disp=16.0):
    """Depth image and (H, W, 4) point cloud of a disparity image."""
    return (depth_mod.disp_to_depth(disp, K.fu, baseline, min_disp),
            depth_mod.depth_from_disparity_vbo(disp, K, baseline, min_disp))


def export_depthmap(out_dir, disp, left_img, fu, baseline, frame=0, timestamp=None,
                    min_disp=0.0):
    """The app's depth-map export: the depth of the disparity as
    SDepth-<index>.pdm (binary "P7" float32) beside the grey
    Left-<index>.pgm, the index the %05d frame counter or, given a
    timestamp, %015.10f of it. Returns the two paths."""
    index = f"{timestamp:015.10f}" if timestamp is not None else f"{int(frame):05d}"
    # fu * baseline of two Python numbers is a double product, rounded to
    # float32 once, as the JAX package computes it
    fb = float(fu) * float(baseline)
    depth = depth_mod.disp_to_depth(disp, fb, 1.0, min_disp).cpu().numpy()
    dpath = os.path.join(out_dir, f"SDepth-{index}.pdm")
    gpath = os.path.join(out_dir, f"Left-{index}.pgm")
    pxm.save_pdm(dpath, depth)
    grey = left_img.cpu().numpy() if torch.is_tensor(left_img) else np.asarray(left_img)
    if grey.dtype != np.uint8:
        grey = np.clip(grey, 0, 255).astype(np.uint8)
    pxm.save_pxm(gpath, grey)
    return dpath, gpath
