"""The DTAM whole-alternation kernel (``csrc/dtam.cu``) and its wrappers.

Counterpart of ``kangaroo_tpu/stereo/dtam_pallas.py`` (``_make_kernel``,
``dtam_solve``, ``dtam_step``): one C call runs ``iterations`` steps of the
alternation in place, two launches per iteration on the current stream (the
dual step, then the primal step fused with the auxiliary search of
``csrc/wta_sq.cuh``).
The plain version is ``apps/stereo.dtam_iterate_plain``, the transcription
of the JAX package's XLA loop. Like that loop the kernel has no gradient,
so an input that requires grad is refused rather than cut from the graph.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build, backend
from ..utils import profiling
from . import wta_cuda

# whole-alternation calls since the last reset (a call of 0 iterations
# launches nothing and is not counted); each also adds its iterations to
# wta_cuda.sq_launches, one auxiliary-search launch per iteration
launches = 0


def anneal(theta, beta, n0, iterations: int) -> np.ndarray:
    """The theta of each iteration and the one after the last, in float32:
    theta_{i+1} = theta_i (1 - beta (n0 + i)), one rounding per operation,
    sequentially, as the JAX loop carries it."""
    out = np.empty(iterations + 1, np.float32)
    t, b, n = np.float32(theta), np.float32(beta), np.float32(n0)
    one = np.float32(1.0)
    for i in range(iterations + 1):
        out[i] = t
        t = t * (one - b * (n + np.float32(i)))
    return out


def _check_plane(t: torch.Tensor, vol: torch.Tensor, name: str) -> None:
    wta_cuda.check_volume_and_plane(vol, t, name, "dtam")
    if t.requires_grad:
        raise RuntimeError(f"dtam: the kernel has no gradient; {name} requires grad")


def _run(entry: str, vol: torch.Tensor, g: torch.Tensor, d: torch.Tensor, a: torch.Tensor,
         q: torch.Tensor, theta, n0, lam, sigma_q, sigma_d, huber_alpha, beta, iterations: int,
         sd: int):
    if vol.requires_grad:
        raise RuntimeError("dtam: the kernel has no gradient; vol requires grad")
    for t, name in ((g, "g"), (d, "d"), (a, "a")):
        _check_plane(t, vol, name)
    if q.shape != vol.shape[1:] + (2,) or q.dtype != torch.float32 or q.device != vol.device:
        raise ValueError(f"dtam: q {tuple(q.shape)} {q.dtype} on {q.device} is not (H, W, 2) "
                         f"float32 beside vol {tuple(vol.shape)} on {vol.device}")
    if q.requires_grad:
        raise RuntimeError("dtam: the kernel has no gradient; q requires grad")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    D, H, W = vol.shape
    thetas = anneal(float(theta), float(beta), float(n0), iterations)
    d, a = d.clone(), a.clone()
    planes = q.permute(2, 0, 1).contiguous()  # (2, H, W): q0, q1
    lib = _build.library()
    with torch.cuda.device(vol.device):
        backend.launch(getattr(lib, entry), vol.data_ptr(), int(vol.dtype == torch.bfloat16),
                       g.data_ptr(), d.data_ptr(), a.data_ptr(), planes.data_ptr(),
                       thetas.ctypes.data, D, H, W, int(sd), float(lam), float(sigma_q),
                       float(sigma_d), float(huber_alpha), int(iterations),
                       backend.stream_handle(vol), op="dtam")
    (theta_out,) = backend.f32_scalars(vol.device, thetas[-1])
    return d, a, planes.permute(1, 2, 0).contiguous(), theta_out


@profiling.spanned("dispatch")
def dtam_run(vol: torch.Tensor, g: torch.Tensor, d: torch.Tensor, a: torch.Tensor,
             q: torch.Tensor, theta, n0, lam, sigma_q, sigma_d, huber_alpha, beta,
             iterations: int, sd: int = -1):
    """``iterations`` steps of the alternation on the card from the state
    (d, a, q, theta); the i-th step anneals with n0 + i. vol (D, H, W)
    float32 or bfloat16; g, d, a (H, W) float32; q (H, W, 2) float32; the
    scalars are numbers or 0-dim tensors (read on the host). The inputs are
    not modified. Returns (d, a, q, theta) with theta a float32 0-dim
    tensor on the card."""
    global launches
    out = _run("kt_dtam_run", vol, g, d, a, q, theta, n0, lam, sigma_q, sigma_d, huber_alpha,
               beta, iterations, sd)
    launches += int(iterations > 0)
    wta_cuda.sq_launches += int(iterations)
    return out


def _dtam_run_split(vol, g, d, a, q, theta, n0, lam, sigma_q, sigma_d, huber_alpha, beta,
                    iterations: int, sd: int = -1):
    """``dtam_run`` through ``kt_dtam_run_split`` (the design it replaced:
    three launches an iteration, the one-thread-per-pixel search): the
    yardstick that the card checks hold ``kt_dtam_run`` against. No path
    calls it and no count records it."""
    return _run("kt_dtam_run_split", vol, g, d, a, q, theta, n0, lam, sigma_q, sigma_d,
                huber_alpha, beta, iterations, sd)


def dtam_solve(vol, g, d0, lam, theta_start, sigma_q, sigma_d, huber_alpha, beta,
               iterations: int = 80, sd: int = -1) -> torch.Tensor:
    """The cold solve on the card from d = a = d0, q = 0, annealing with
    n0 = 1 (``dtam_pallas.dtam_solve``). Returns d."""
    q = torch.zeros(d0.shape + (2,), dtype=torch.float32, device=d0.device)
    return dtam_run(vol, g, d0, d0, q, theta_start, 1.0, lam, sigma_q, sigma_d, huber_alpha,
                    beta, iterations, sd)[0]


def dtam_step(vol, g, d, a, q, theta, n, lam, sigma_q, sigma_d, huber_alpha, beta,
              iterations: int = 5, sd: int = -1):
    """Resume from (d, a, q, theta) with the global counter n for
    ``iterations`` steps (``dtam_pallas.dtam_step``). Returns
    (d, a, q, theta, n + iterations), theta and n float32 0-dim tensors."""
    d, a, q, theta = dtam_run(vol, g, d, a, q, theta, n, lam, sigma_q, sigma_d, huber_alpha,
                              beta, iterations, sd)
    (n_out,) = backend.f32_scalars(vol.device, float(n) + iterations)
    return d, a, q, theta, n_out
