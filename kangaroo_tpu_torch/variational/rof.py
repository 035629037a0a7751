"""ROF / Huber-ROF primal-dual denoising (``kangaroo_tpu/variational/rof.py``).

The dual ascent steps (TV-L1, Huber, weighted Huber) and primal descent
steps (L2 data term, pixelwise lambda, edge-weighted) as plain functions.
:func:`denoise` runs the whole solve: on a CUDA tensor in the ROF kernel
(``solvers_cuda.rof_denoise``), on a CPU tensor in its plain version,
:func:`denoise_plain`, the counterpart of the JAX package's XLA loop.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars
from . import ops, solvers_cuda


def tvl1_dual_ascent_p(p, u, sigma):
    """p <- Pi(p + sigma grad u)."""
    return ops.project_unit_ball(p + sigma * ops.grad_forward(u))


def huber_dual_ascent_p(p, u, sigma, alpha):
    """Huber prox: divide by (1 + sigma*alpha) before projection."""
    np_ = (p + sigma * ops.grad_forward(u)) / (1.0 + sigma * alpha)
    return ops.project_unit_ball(np_)


def weighted_huber_dual_ascent_p(p, u, w, sigma, alpha):
    """Edge-weighted Huber dual ascent."""
    np_ = (p + sigma * w[..., None] * ops.grad_forward(u)) / (1.0 + sigma * alpha)
    return ops.project_unit_ball(np_)


def l2_primal_descent(u, p, g, tau, lam, lambda_weight=None):
    """u <- (u + tau (div p + lambda g)) / (1 + tau lambda)."""
    if lambda_weight is not None:
        lam = lam * lambda_weight
    divp = ops.divergence(p)
    return (u + tau * (divp + lam * g)) / (1.0 + tau * lam)


def weighted_l2_primal_descent(u, p, g, w, tau, lam):
    """Edge-weighted primal descent: u <- (u + tau (w div p + lambda g)) /
    (1 + tau lambda)."""
    divp = ops.divergence(p)
    return (u + tau * (w * divp + lam * g)) / (1.0 + tau * lam)


def denoise(g, lam, sigma=0.5, tau=0.25, alpha=0.002, iterations: int = 100,
            model: str = "huber"):
    """Full ROF solve of the (H, W) image ``g``; model in {'tv', 'huber'}.
    Returns float32 (H, W)."""
    if g.device.type == "cpu":
        return denoise_plain(g, lam, sigma, tau, alpha, iterations, model)
    return solvers_cuda.rof_denoise(g.to(torch.float32).contiguous(), lam, sigma, tau, alpha,
                                    iterations, model)


def denoise_plain(g, lam, sigma=0.5, tau=0.25, alpha=0.002, iterations: int = 100,
                  model: str = "huber", lam_weight=None):
    """The plain version of the ROF kernel: ``iterations`` dual ascent and
    primal descent steps from u = g, p = 0. ``lam_weight`` (H, W) makes the
    data weight pixelwise (lam * weight), the inpainting mode."""
    if model not in ("tv", "huber"):
        raise ValueError(f"model must be 'tv' or 'huber', got {model!r}")
    lam, sigma, tau, alpha = f32_scalars(g.device, lam, sigma, tau, alpha)
    g = g.to(torch.float32)
    lamw = None if lam_weight is None else lam_weight.to(torch.float32)
    u = g
    p = torch.zeros(g.shape + (2,), dtype=g.dtype, device=g.device)
    for _ in range(iterations):
        if model == "tv":
            p = tvl1_dual_ascent_p(p, u, sigma)
        else:
            p = huber_dual_ascent_p(p, u, sigma, alpha)
        u = l2_primal_descent(u, p, g, tau, lam, lambda_weight=lamw)
    return u
