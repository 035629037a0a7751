"""Dispatch of the stereo paths' ops between kernel and plain version
(``kangaroo_tpu/stereo/dispatch.py``).

A tensor on the CPU takes the plain PyTorch version. Any other tensor goes
through ``_KernelOp``, whose forward launches the CUDA kernel (which raises
off an sm_90 card) and whose backward re-runs the plain version under
autograd on the saved inputs — the JAX package's custom_vjp contract: the
kernel computes the primal, the plain version's gradient is its gradient.
The SGM segments of the multi-device paths (``sgm_aggregate_scan``,
``sgm_aggregate_block``, ``sgm_aggregate_diag_block``) have no gradient in
the JAX package either: they call the kernel directly and refuse inputs
that require grad. There is no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

import torch

from ..backend import f32_scalars
from ..ops import median as _median
from ..ops import median_cuda
from ..utils import profiling
from . import costvolume as _cv
from . import lr_cuda, sgm_cuda, wta_cuda
from . import sgm as _sgm


class _KernelOp(torch.autograd.Function):
    """forward: ``kernel(*inputs, **kwargs)``, a tensor or a tuple of them,
    inside a ``dispatch`` span named after the kernel's wrapper; backward:
    the vector-Jacobian product of ``plain(*inputs, **kwargs)``, each output
    with its own incoming gradient."""

    @staticmethod
    def forward(ctx, kernel, plain, kwargs, *inputs):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*inputs)
        with profiling.span(kernel, "dispatch"):
            return kernel(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves, **ctx.kwargs)
        outs = [(o, g) for o, g in zip(out if isinstance(out, tuple) else (out,), grads)
                if o.requires_grad and g is not None]
        wrt = [t for t in leaves if t.requires_grad]
        if outs:
            grads = iter(torch.autograd.grad([o for o, _ in outs], wrt, [g for _, g in outs],
                                             allow_unused=True))
        else:  # no output depends on the inputs asked for
            grads = iter([None] * len(wrt))
        return (None, None, None, *(next(grads) if n else None for n in needs))


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def semi_global_matching(vol, img, P1=0.01, P2=0.02, do_horiz=True, do_vert=True,
                         do_reverse=True, do_diagonal=False, sd=-1, seam_period=None):
    kw = dict(P1=float(P1), P2=float(P2), do_horiz=do_horiz, do_vert=do_vert,
              do_reverse=do_reverse, do_diagonal=do_diagonal, sd=sd, seam_period=seam_period)
    if _on_cpu(vol):
        return _sgm.semi_global_matching(vol, img, **kw)
    return _KernelOp.apply(sgm_cuda.semi_global_matching, _sgm.semi_global_matching,
                           kw, vol, img)


def sgm_aggregate_scan(vol, img, *args, **kwargs):
    """Both directions of one axis of a column shard, a row shard or a
    stacked batch (``stereo.sgm.sgm_aggregate_scan``)."""
    fn = _sgm.sgm_aggregate_scan if _on_cpu(vol) else sgm_cuda.sgm_aggregate_scan
    return fn(vol, img, *args, **kwargs)


def sgm_aggregate_block(vol, img, *args, **kwargs):
    """A vertical row segment with a carry (``stereo.sgm.sgm_aggregate_block``)."""
    fn = _sgm.sgm_aggregate_block if _on_cpu(vol) else sgm_cuda.sgm_aggregate_block
    return fn(vol, img, *args, **kwargs)


def sgm_aggregate_diag_block(vol, img, *args, **kwargs):
    """A diagonal row segment with a carry
    (``stereo.sgm.sgm_aggregate_diag_block``)."""
    fn = _sgm.sgm_aggregate_diag_block if _on_cpu(vol) else sgm_cuda.sgm_aggregate_diag_block
    return fn(vol, img, *args, **kwargs)


def cost_vol_minimum_subpix(vol, sd=-1):
    if _on_cpu(vol):
        return _cv.cost_vol_minimum_subpix(vol, sd)
    return _KernelOp.apply(wta_cuda.cost_vol_minimum_subpix, _cv.cost_vol_minimum_subpix,
                           dict(sd=sd), vol)


def cost_vol_minimum_square_penalty_subpix(vol, last_disp, lam, theta, sd=-1):
    """The DTAM auxiliary search; ``lam`` and ``theta`` are differentiable
    inputs too, as in the JAX package's custom_vjp."""
    if _on_cpu(vol):
        return _cv.cost_vol_minimum_square_penalty_subpix(vol, last_disp, lam, theta, sd)
    lam, theta = f32_scalars(vol.device, lam, theta)
    return _KernelOp.apply(wta_cuda.cost_vol_minimum_square_penalty_subpix,
                           _cv.cost_vol_minimum_square_penalty_subpix, dict(sd=sd),
                           vol, last_disp, lam, theta)


def median_filter_reject_invalid(img, max_bad: int, rad: int = 2):
    """An (H, W) image, or each image of an (N, H, W) stack."""
    kw = dict(max_bad=int(max_bad), rad=int(rad))
    if _on_cpu(img):
        return _median.median_filter_reject_invalid(img, **kw)
    return _KernelOp.apply(median_cuda.median_filter_reject_invalid,
                           _median.median_filter_reject_invalid, kw, img)


def left_right_check(disp_l, disp_r, sd: int = -1, max_diff=1.0, max_disp: int = 192):
    kw = dict(sd=sd, max_diff=float(max_diff), max_disp=int(max_disp))
    if _on_cpu(disp_l):
        return _cv.left_right_check(disp_l, disp_r, **kw)
    return _KernelOp.apply(lr_cuda.left_right_check, _cv.left_right_check, kw,
                           disp_l, disp_r)


def left_right_check_pair(disp_l, disp_r, max_diff=1.0, max_disp: int = 192):
    """Both directions of a frame, the right image checked first; returns
    (disp_l', disp_r')."""
    kw = dict(max_diff=float(max_diff), max_disp=int(max_disp))
    if _on_cpu(disp_l):
        return _cv.left_right_check_pair(disp_l, disp_r, **kw)
    return _KernelOp.apply(lr_cuda.left_right_check_pair, _cv.left_right_check_pair, kw,
                           disp_l, disp_r)
