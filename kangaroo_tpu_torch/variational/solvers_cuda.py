"""The ROF and TGV kernels (``csrc/rof.cu``, ``csrc/tgv.cu``) and their wrappers.

Counterpart of ``kangaroo_tpu/variational/pallas_solvers.py``
(``rof_denoise``, ``tgv_denoise``): one C call runs a whole solve on the
current stream. Both run several iterations a launch on tiles in shared
memory: ROF ``ROF_STEPS`` (``kt_rof_denoise``), TGV ``TGV_STEPS``
(``kt_tgv_denoise``). The plain versions are ``rof.denoise_plain`` and
``tgv.denoise_plain``. The kernels have no gradient (the JAX package's
solvers have none either), so an input that requires grad is refused rather
than cut from the graph.
"""
from __future__ import annotations

import torch

from .. import _build, backend
from ..utils import profiling

# solves launched since the last reset (a ROF solve is ceil(iterations /
# ROF_STEPS) kernel launches, a TGV solve ceil(iterations / TGV_STEPS); a
# solve of 0 iterations launches none and is not counted)
rof_launches = 0
tgv_launches = 0
# iterations a launch runs (kSteps of csrc/rof.cu and of csrc/tgv.cu)
ROF_STEPS = 4
TGV_STEPS = 4


def _check_image(t: torch.Tensor, name: str, op: str) -> None:
    backend.require_kernels(t, op)
    backend.check_tensor(t, name, (torch.float32,), 2)
    if t.requires_grad:
        raise RuntimeError(f"{op}: the kernel has no gradient; {name} requires grad")


def _rof(entry: str, planes: int, g: torch.Tensor, lam, sigma, tau, alpha, iterations: int,
         model: str, lam_weight: torch.Tensor | None) -> torch.Tensor:
    _check_image(g, "g", "rof")
    if lam_weight is not None:
        _check_image(lam_weight, "lam_weight", "rof")
        if lam_weight.shape != g.shape or lam_weight.device != g.device:
            raise ValueError(f"lam_weight {tuple(lam_weight.shape)} on {lam_weight.device} "
                             f"does not match g {tuple(g.shape)} on {g.device}")
    if model not in ("tv", "huber"):
        raise ValueError(f"model must be 'tv' or 'huber', got {model!r}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    H, W = g.shape
    u = torch.empty_like(g)
    scratch = torch.empty((planes, H, W), dtype=torch.float32, device=g.device)
    lib = _build.library()
    with torch.cuda.device(g.device):
        backend.launch(getattr(lib, entry), g.data_ptr(),
                       None if lam_weight is None else lam_weight.data_ptr(), u.data_ptr(),
                       scratch.data_ptr(), H, W, float(lam), float(sigma), float(tau),
                       float(alpha), int(model == "huber"), int(iterations),
                       backend.stream_handle(g), op="rof")
    return u


@profiling.spanned("dispatch")
def rof_denoise(g: torch.Tensor, lam, sigma=0.5, tau=0.25, alpha=0.002,
                iterations: int = 100, model: str = "huber",
                lam_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Whole ROF / Huber-ROF solve on the card: g (H, W) float32 -> u (H, W)
    float32. ``lam_weight`` (H, W) float32 makes the data weight pixelwise
    (lam * weight), the inpainting mode. The scratch is the second copy of u
    and both copies of p0, p1: each launch reads one copy of the state and
    writes the other."""
    global rof_launches
    u = _rof("kt_rof_denoise", 5, g, lam, sigma, tau, alpha, iterations, model, lam_weight)
    rof_launches += int(iterations > 0)
    return u


def _rof_denoise_steps(g: torch.Tensor, lam, sigma=0.5, tau=0.25, alpha=0.002,
                       iterations: int = 100, model: str = "huber",
                       lam_weight: torch.Tensor | None = None) -> torch.Tensor:
    """``rof_denoise`` through ``kt_rof_denoise_steps`` (the design it
    replaced: a dual and a primal launch an iteration, one thread a pixel,
    in place on one copy of p): the yardstick that the card checks hold
    ``kt_rof_denoise`` against. No path calls it and no count records it."""
    return _rof("kt_rof_denoise_steps", 2, g, lam, sigma, tau, alpha, iterations, model,
                lam_weight)


def _tgv(entry: str, planes: int, f: torch.Tensor, alpha0, alpha1, sigma, tau, delta,
         iterations: int) -> torch.Tensor:
    _check_image(f, "f", "tgv")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    H, W = f.shape
    u = torch.empty_like(f)
    scratch = torch.empty((planes, H, W), dtype=torch.float32, device=f.device)
    lib = _build.library()
    with torch.cuda.device(f.device):
        backend.launch(getattr(lib, entry), f.data_ptr(), u.data_ptr(), scratch.data_ptr(), H,
                       W, float(alpha0), float(alpha1), float(sigma), float(tau), float(delta),
                       int(iterations), backend.stream_handle(f), op="tgv")
    return u


@profiling.spanned("dispatch")
def tgv_denoise(f: torch.Tensor, alpha0=2.0, alpha1=1.0, sigma=0.5, tau=0.25, delta=0.1,
                iterations: int = 100) -> torch.Tensor:
    """Whole TGV-L1 solve on the card: f (H, W) float32 -> u (H, W) float32.
    The scratch is the second copy of u and both copies of the other eight
    planes (v0, v1, p0, p1, q0, q1, q2, r): each launch reads one copy of the
    state and writes the other."""
    global tgv_launches
    u = _tgv("kt_tgv_denoise", 17, f, alpha0, alpha1, sigma, tau, delta, iterations)
    tgv_launches += int(iterations > 0)
    return u


def _tgv_denoise_steps(f: torch.Tensor, alpha0=2.0, alpha1=1.0, sigma=0.5, tau=0.25, delta=0.1,
                       iterations: int = 100) -> torch.Tensor:
    """``tgv_denoise`` through ``kt_tgv_denoise_steps`` (the design it
    replaced: an ascent and a descent launch an iteration, one thread a
    pixel, in place on one copy of the eight planes besides u): the
    yardstick that the card checks hold ``kt_tgv_denoise`` against. No path
    calls it and no count records it."""
    return _tgv("kt_tgv_denoise_steps", 8, f, alpha0, alpha1, sigma, tau, delta, iterations)
