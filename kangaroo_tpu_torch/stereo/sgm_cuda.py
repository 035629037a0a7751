"""The SGM aggregation kernel (``csrc/sgm.cu``) and its Python wrapper.

Counterpart of ``kangaroo_tpu/stereo/sgm_pallas.py`` (``_make_kernel`` for
the straight paths, ``_make_multi_diag_kernel`` for the 8-path mode,
``semi_global_matching``): one launch per path direction, chained through
one f32 output. The plain version is ``stereo/sgm.semi_global_matching``.
"""
from __future__ import annotations

import torch

from .. import _build, backend

# kernel launches since the last reset, one per path direction: the
# straight directions, and the diagonals of the 8-path mode
launches = 0
diagonal_launches = 0

# steps (sx, sy) in the plain version's sum order: pixel (x, y) continues
# the path from (x - sx, y - sy)
_VERTICAL = ((0, 1), (0, -1))
_HORIZONTAL = ((1, 0), (-1, 0))
_DIAGONAL = ((1, 1), (-1, 1), (1, -1), (-1, -1))


def semi_global_matching(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01,
                         P2: float = 0.02, do_horiz: bool = True, do_vert: bool = True,
                         do_reverse: bool = True, do_diagonal: bool = False,
                         sd: int = -1) -> torch.Tensor:
    """4-path (8-path with ``do_diagonal``) SGM on the card: vol (D, H, W)
    float32 or bfloat16 with D <= 256, img (H, W) float32 -> aggregated
    (D, H, W) float32. The four diagonals ignore ``do_vert`` and
    ``do_reverse``, as in the JAX package."""
    global launches, diagonal_launches
    backend.require_kernels(vol, "sgm")
    backend.check_tensor(vol, "vol", (torch.float32, torch.bfloat16), 3)
    backend.check_tensor(img, "img", (torch.float32,), 2)
    D, H, W = vol.shape
    if img.shape != (H, W) or img.device != vol.device:
        raise ValueError(f"img {tuple(img.shape)} on {img.device} does not match "
                         f"vol {tuple(vol.shape)} on {vol.device}")
    if not 1 <= D <= 256:
        raise ValueError(f"sgm kernel takes 1 <= D <= 256, got {D}")
    steps = [st for pair, on in ((_VERTICAL, do_vert), (_HORIZONTAL, do_horiz)) if on
             for st in (pair if do_reverse else pair[:1])]
    if do_diagonal:
        steps += _DIAGONAL
    if not steps:
        return torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
    out = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    lib = _build.library()
    with torch.cuda.device(vol.device):
        stream = backend.stream_handle(vol)
        for i, (sx, sy) in enumerate(steps):
            rc = lib.kt_sgm_path(
                vol.data_ptr(), int(vol.dtype == torch.bfloat16), img.data_ptr(),
                out.data_ptr(), D, H, W, sx, sy, int(sd), float(P1), float(P2),
                int(i > 0), stream)
            backend.check_launch(rc, "sgm")
            if sx and sy:
                diagonal_launches += 1
            else:
                launches += 1
    return out
