"""Where a tensor's ops run: the CUDA kernels on an sm_90 card, else plain.

Counterpart of ``kangaroo_tpu/backend.py``. There is no environment
override: a CPU tensor takes the plain PyTorch version of an op, a CUDA
tensor takes the kernel, and a CUDA tensor on a card the kernels were not
built for raises. Tests and comparisons call the plain versions by name.
"""
from __future__ import annotations

import functools

import torch

from .utils import profiling

# the kernels are built for sm_90a only (_build.NVCC_FLAGS)
KERNEL_CAPABILITY = (9, 0)


def kernels_available(t: torch.Tensor) -> bool:
    """True iff ``t`` lies on a CUDA device the kernels were built for."""
    return t.is_cuda and torch.cuda.get_device_capability(t.device) == KERNEL_CAPABILITY


def require_kernels(t: torch.Tensor, op: str) -> None:
    """Raise unless ``op``'s kernel can run on ``t``'s device."""
    if not kernels_available(t):
        raise RuntimeError(
            f"{op}: the CUDA kernel needs a tensor on an sm_90 device, got "
            f"{t.device}" + (f" (capability {torch.cuda.get_device_capability(t.device)})"
                             if t.is_cuda else ""))


def check_tensor(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Validate a kernel argument: dtype, rank and contiguity."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(entry, *args, op: str) -> None:
    """Call a kernel's C entry (a function of ``_build.library()``) with
    ``args`` inside its ``kernel`` span, named after the entry; raise if it
    returned a CUDA error code."""
    with profiling.span(entry.__name__, "kernel"):
        rc = entry(*args)
    if rc != 0:
        raise RuntimeError(f"{op}: kernel launch failed with cudaError {rc}")


def f32_scalars(device, *values) -> list[torch.Tensor]:
    """Scalars as float32 tensors on ``device``, so that their products
    round in float32 as the JAX package's traced constants (and the
    kernels) do; a tensor is cast and moved. On the device, not the CPU:
    PyTorch divides a CUDA tensor by a CPU scalar as a multiply by its
    reciprocal, which rounds differently from the kernels' division. Made
    by a fill, not a copy from the host, so the stream is not waited for."""
    return [v.to(device=device, dtype=torch.float32) if isinstance(v, torch.Tensor)
            else torch.full((), float(v), dtype=torch.float32, device=device) for v in values]


def _hashable(values):
    return tuple(map(_hashable, values)) if isinstance(values, (list, tuple)) else values


@functools.lru_cache(maxsize=256)
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """A small constant tensor on ``device``, made once and then reused: a
    tensor made from host data on the card is a copy from pageable memory,
    which first waits for everything queued on the stream. Callers must
    not write to it."""
    return _constant(_hashable(values), dtype, str(torch.device(device)))
