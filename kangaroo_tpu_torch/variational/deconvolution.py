"""TV-regularised deconvolution and inpainting
(``kangaroo_tpu/variational/deconvolution.py``).

Deconvolution iterates, as the JAX package does:

  p   <- HuberDualAscent(p, u)
  Au  <- k * u
  q   <- (q + sigma_q (Au - g)) / (1 + sigma_q / lambda)
  ATq <- k^T * q
  u   <- u + tau (div p - lambda ATq)

It is plain PyTorch on every device (the JAX package has no kernel for
it). Inpainting is ROF denoising with pixelwise lambda = lam * mask: on a
CUDA tensor it runs the ROF kernel with the mask as its lambda weight.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars
from ..ops.convolution import convolve
from . import ops, rof, solvers_cuda


def dual_q_ascent(q, Au, g, sigma_q, lam):
    return (q + sigma_q * (Au - g)) / (1.0 + sigma_q / lam)


def primal_u_descent(u, p, ATq, tau, lam):
    return u + tau * (ops.divergence(p) - lam * ATq)


def deconvolve(g, kernel, lam=10.0, sigma_q=0.2, sigma_p=0.2, tau=0.05,
               alpha=0.002, iterations: int = 200):
    """Recover u from the blurry (H, W) image g with blur kernel ``kernel``."""
    lam, sigma_q, sigma_p, tau, alpha = f32_scalars(g.device, lam, sigma_q, sigma_p, tau,
                                                    alpha)
    g = g.to(torch.float32)
    kernel = torch.as_tensor(kernel, dtype=torch.float32, device=g.device)
    kT = torch.flip(kernel, dims=(0, 1))
    u = g
    p = torch.zeros(g.shape + (2,), dtype=g.dtype, device=g.device)
    q = torch.zeros_like(g)
    for _ in range(iterations):
        p = rof.huber_dual_ascent_p(p, u, sigma_p, alpha)
        Au = convolve(u, kernel, normalize=True)
        q = dual_q_ascent(q, Au, g, sigma_q, lam)
        ATq = convolve(q, kT, normalize=True)
        u = primal_u_descent(u, p, ATq, tau, lam)
    return u


def inpaint(g, mask, lam=10.0, sigma=0.5, tau=0.25, alpha=0.002,
            iterations: int = 300):
    """TV inpainting: Huber-ROF denoising with pixelwise lambda = lam * mask,
    where mask is 1 where data is trusted and 0 where it must be filled."""
    if g.device.type == "cpu":
        return rof.denoise_plain(g, lam, sigma, tau, alpha, iterations, "huber",
                                 lam_weight=mask)
    return solvers_cuda.rof_denoise(g.to(torch.float32).contiguous(), lam, sigma, tau, alpha,
                                    iterations, "huber",
                                    lam_weight=mask.to(torch.float32).contiguous())
