"""Second-order TGV-L1 primal-dual denoising (``kangaroo_tpu/variational/tgv.py``).

One iteration is the five half-steps AscentP, AscentQ, AscentR, DescentU,
DescentV in order, each reading the previous ones' results.
:func:`denoise` runs the whole solve: on a CUDA tensor in the TGV kernel
(``solvers_cuda.tgv_denoise``), on a CPU tensor in its plain version,
:func:`denoise_plain`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..backend import f32_scalars
from . import ops, solvers_cuda


class TgvState(NamedTuple):
    u: torch.Tensor  # (H, W) primal
    v: torch.Tensor  # (H, W, 2) primal vector field
    p: torch.Tensor  # (H, W, 2) dual of grad u - v
    q: torch.Tensor  # (H, W, 3) dual of Epsilon(v)
    r: torch.Tensor  # (H, W) data dual


def init(f: torch.Tensor) -> TgvState:
    H, W = f.shape
    kw = dict(dtype=f.dtype, device=f.device)
    return TgvState(u=f, v=torch.zeros((H, W, 2), **kw), p=torch.zeros((H, W, 2), **kw),
                    q=torch.zeros((H, W, 3), **kw), r=torch.zeros((H, W), **kw))


def ascent(s: TgvState, f, alpha0, alpha1, sigma, delta):
    """AscentP, AscentQ, AscentR: the new duals (p, q, r)."""
    p = ops.project_unit_ball(s.p + sigma * alpha1 * (ops.grad_forward(s.u) - s.v))
    q = ops.project_unit_ball_sym(s.q + sigma * alpha0 * ops.epsilon(s.v))
    r = ops.project_unit_ball_scalar((s.r + sigma * (s.u - f)) / (1.0 + sigma * delta))
    return p, q, r


def descent(s: TgvState, p, q, r, alpha0, alpha1, tau):
    """DescentU, DescentV from the new duals: the new primals (u, v)."""
    u = s.u - tau * (r - alpha1 * ops.divergence(p))
    v = s.v - tau * (-alpha1 * p - alpha0 * ops.divergence_sym(q))
    return u, v


def iteration(s: TgvState, f, alpha0, alpha1, sigma, tau, delta) -> TgvState:
    """One TGV-L1 primal-dual iteration; the half-steps in order."""
    p, q, r = ascent(s, f, alpha0, alpha1, sigma, delta)
    u, v = descent(s, p, q, r, alpha0, alpha1, tau)
    return TgvState(u, v, p, q, r)


def denoise(f, alpha0=2.0, alpha1=1.0, sigma=0.5, tau=0.25, delta=0.1,
            iterations: int = 100):
    """Full TGV-L1 denoise of the (H, W) image ``f``; returns float32 (H, W)."""
    if f.device.type == "cpu":
        return denoise_plain(f, alpha0, alpha1, sigma, tau, delta, iterations)
    return solvers_cuda.tgv_denoise(f.to(torch.float32).contiguous(), alpha0, alpha1, sigma,
                                    tau, delta, iterations)


def denoise_plain(f, alpha0=2.0, alpha1=1.0, sigma=0.5, tau=0.25, delta=0.1,
                  iterations: int = 100):
    """The plain version of the TGV kernel: ``iterations`` iterations from
    u = f and every dual and v at 0."""
    consts = f32_scalars(f.device, alpha0, alpha1, sigma, tau, delta)
    f = f.to(torch.float32)
    s = init(f)
    for _ in range(iterations):
        s = iteration(s, f, *consts)
    return s.u
