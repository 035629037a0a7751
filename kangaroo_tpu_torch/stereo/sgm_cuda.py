"""The SGM aggregation kernels and their Python wrappers.

Counterpart of ``kangaroo_tpu/stereo/sgm_pallas.py``, all four kernels in
``csrc/sgm_path.cu``: ``_make_kernel`` for the straight paths and
``_make_multi_diag_kernel`` for the 8-path mode (``kt_sgm_path``:
``semi_global_matching``, ``aggregate_direction`` and the whole-line scans
of ``sgm_aggregate_scan``), ``_make_kernel``'s lane-offset, seam and carry
variants (``sgm_aggregate_scan``, ``sgm_aggregate_block``,
``semi_global_matching(seam_period=)``) and ``_make_diag_kernel``
(``sgm_aggregate_diag_block``) (``kt_sgm_segment``). One launch per path
direction, chained through one f32 output. ``csrc/sgm.cu``'s warp-per-line
design (``kt_sgm_segment_lines``, through ``_launch_lines``) is what the
card checks hold those kernels against; nothing here calls it. The plain
versions are the functions of the same names in ``stereo/sgm.py``, whose
docstrings give the semantics; the volumes keep the (D, S, N) layout there
too. The segments have no gradient (the JAX package gives them none) and
refuse inputs that require one.
"""
from __future__ import annotations

import torch

from .. import _build, backend
from ..utils import profiling
from . import sgm as _plain

# kernel launches since the last reset, one per path direction: the
# straight directions of whole lines (kernel 1) and the diagonals of the
# 8-path mode (kernel 5), both ``kt_sgm_path``; the straight segments with
# a lane offset, a seam period or a carry (kernel 7), and the diagonal
# segments with a carry (kernel 6), both ``kt_sgm_segment``
launches = 0
diagonal_launches = 0
# the horizontal directions among ``launches`` (``sgm_cols_kernel``); a
# part of a counted total, so not one of ``profiling.COUNTERS``
horizontal_launches = 0
segment_launches = 0
diag_segment_launches = 0

# steps (sx, sy) in the plain version's sum order: pixel (x, y) continues
# the path from (x - sx, y - sy)
_VERTICAL = ((0, 1), (0, -1))
_HORIZONTAL = ((1, 0), (-1, 0))
_DIAGONAL = ((1, 1), (-1, 1), (1, -1), (-1, -1))


def _check_volume(vol: torch.Tensor, img: torch.Tensor, op: str) -> None:
    """vol (D, S, N) float32/bfloat16 with D <= 256 and img (S, N) float32
    on one sm_90 card, each with unit stride along N (views of column
    blocks are read in place)."""
    backend.require_kernels(vol, op)
    for name, t, dtypes, ndim in (("vol", vol, (torch.float32, torch.bfloat16), 3),
                                  ("img", img, (torch.float32,), 2)):
        if t.dtype not in dtypes:
            raise TypeError(f"{op}: {name} dtype {t.dtype} not in {dtypes}")
        if t.dim() != ndim or t.stride(-1) != 1:
            raise ValueError(f"{op}: {name} must be {ndim}-D with unit stride along its last "
                             f"axis, got shape {tuple(t.shape)} strides {t.stride()}")
        if t.requires_grad:
            raise RuntimeError(f"{op}: the kernel has no gradient; {name} requires grad")
    D, S, N = vol.shape
    if tuple(img.shape) != (S, N) or img.device != vol.device:
        raise ValueError(f"{op}: img {tuple(img.shape)} on {img.device} does not match "
                         f"vol {tuple(vol.shape)} on {vol.device}")
    if not 1 <= D <= 256:
        raise ValueError(f"{op}: the kernel takes 1 <= D <= 256, got {D}")


def _output(vol: torch.Tensor, acc: torch.Tensor | None, op: str) -> torch.Tensor:
    """The float32 result: ``acc`` itself (updated in place), or new."""
    if acc is None:
        return torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    if (acc.dtype != torch.float32 or acc.shape != vol.shape or acc.device != vol.device
            or acc.stride(-1) != 1):
        raise ValueError(f"{op}: acc must be float32 {tuple(vol.shape)} on {vol.device} with "
                         f"unit stride along its last axis, got {acc.dtype} "
                         f"{tuple(acc.shape)} on {acc.device}")
    if acc.requires_grad:
        raise RuntimeError(f"{op}: the kernel has no gradient; acc requires grad")
    return acc


def _carry(t: torch.Tensor, name: str, shape, device) -> torch.Tensor:
    """A carry input as a contiguous float32 tensor of ``shape``."""
    if t is None or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} on {device}, got "
                         f"{None if t is None else (tuple(t.shape), t.device)}")
    if t.requires_grad:
        raise RuntimeError(f"the SGM segments have no gradient; {name} requires grad")
    return t.to(torch.float32).contiguous()


def _segment(entry, vol, img, out, acc, step, sd, xoff, width, seam, P1, P2, op, carry_in,
             carry_out) -> None:
    D, S, N = vol.shape
    cin = list(carry_in or ())
    cin += [None] * (4 - len(cin))
    cout = carry_out or (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(vol.device):
        backend.launch(getattr(_build.library(), entry), vol.data_ptr(),
                       int(vol.dtype == torch.bfloat16), vol.stride(0), vol.stride(1),
                       img.data_ptr(), img.stride(0), out.data_ptr(), ptr(acc), out.stride(0),
                       out.stride(1), D, S, N, step[0], step[1], int(sd), int(xoff), int(width),
                       int(seam), float(P1), float(P2), *map(ptr, cin), *map(ptr, cout),
                       backend.stream_handle(vol), op=op)


def _launch(vol, img, out, acc, step, sd, xoff, width, seam, P1, P2, op,
            carry_in=None, carry_out=None) -> None:
    """One vertical or diagonal direction over vol (D, S, N) through
    ``kt_sgm_segment`` (kernel 7, or 6 for a diagonal step); writes Lr into
    ``out`` (``acc`` + Lr when ``acc`` is given: it may be ``out``).
    ``carry_in``: (prev, best, img[, has]) contiguous float32;
    ``carry_out``: (prev, best) to fill."""
    _segment("kt_sgm_segment", vol, img, out, acc, step, sd, xoff, width, seam, P1, P2, op,
             carry_in, carry_out)


def _launch_lines(vol, img, out, acc, step, sd, xoff, width, seam, P1, P2, op,
                  carry_in=None, carry_out=None) -> None:
    """``_launch`` through ``kt_sgm_segment_lines`` (``csrc/sgm.cu``, the
    warp-per-line design; any step): the yardstick that the card checks
    hold ``kt_sgm_segment`` and ``kt_sgm_path`` against. No path calls it
    and no count records it."""
    _segment("kt_sgm_segment_lines", vol, img, out, acc, step, sd, xoff, width, seam, P1, P2, op,
             carry_in, carry_out)


def _path(vol, img, out, step, sd, P1, P2, accumulate, op) -> None:
    """One direction over whole lines of vol (D, S, N) through
    ``kt_sgm_path`` (kernel 1, or 5 for a diagonal step): writes Lr into
    ``out``, or adds it onto ``out`` in place with ``accumulate``. Each
    tensor is read and written through its strides (unit along N)."""
    global launches, diagonal_launches, horizontal_launches
    D, S, N = vol.shape
    with torch.cuda.device(vol.device):
        backend.launch(_build.library().kt_sgm_path, vol.data_ptr(),
                       int(vol.dtype == torch.bfloat16), vol.stride(0), vol.stride(1),
                       img.data_ptr(), img.stride(0), out.data_ptr(), out.stride(0),
                       out.stride(1), D, S, N, step[0], step[1], int(sd), float(P1), float(P2),
                       int(bool(accumulate)), backend.stream_handle(vol), op=op)
    if step[0] and step[1]:
        diagonal_launches += 1
    else:
        launches += 1
        horizontal_launches += int(step[1] == 0)


def aggregate_direction(vol: torch.Tensor, img: torch.Tensor, step, P1: float = 0.01,
                        P2: float = 0.02, sd: int = -1, acc: torch.Tensor | None = None):
    """One path direction ``step`` = (sx, sy) over vol (D, S, N) on the card
    (kernel 1, or 5 for a diagonal): Lr (D, S, N) float32, added onto
    ``acc`` in place when given. See ``stereo.sgm.aggregate_direction``."""
    op = "sgm"
    _check_volume(vol, img, op)
    sx, sy = _plain._check_step(step)
    if sd not in (-1, 1):
        raise ValueError(f"sd must be -1 or 1, got {sd}")
    out = _output(vol, acc, op)
    _path(vol, img, out, (sx, sy), sd, P1, P2, acc is not None, op)
    return out


def semi_global_matching(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01,
                         P2: float = 0.02, do_horiz: bool = True, do_vert: bool = True,
                         do_reverse: bool = True, do_diagonal: bool = False,
                         sd: int = -1, seam_period: int | None = None) -> torch.Tensor:
    """4-path (8-path with ``do_diagonal``) SGM on the card: vol (D, H, W)
    float32 or bfloat16 with D <= 256, img (H, W) float32 -> aggregated
    (D, H, W) float32. The four diagonals ignore ``do_vert`` and
    ``do_reverse``, as in the JAX package. ``seam_period`` re-seeds the
    vertical paths every that many rows (a stacked frame batch, 4-path):
    those directions run the segment kernel (kernel 7)."""
    global segment_launches
    backend.require_kernels(vol, "sgm")
    backend.check_tensor(vol, "vol", (torch.float32, torch.bfloat16), 3)
    backend.check_tensor(img, "img", (torch.float32,), 2)
    D, H, W = vol.shape
    if img.shape != (H, W) or img.device != vol.device:
        raise ValueError(f"img {tuple(img.shape)} on {img.device} does not match "
                         f"vol {tuple(vol.shape)} on {vol.device}")
    if not 1 <= D <= 256:
        raise ValueError(f"sgm kernel takes 1 <= D <= 256, got {D}")
    if seam_period is not None:
        _plain._check_scan(H, W, False, W, 0, seam_period)
        if do_diagonal:
            raise ValueError("a stacked batch (seam_period) aggregates 4 paths only")
    steps = [st for pair, on in ((_VERTICAL, do_vert), (_HORIZONTAL, do_horiz)) if on
             for st in (pair if do_reverse else pair[:1])]
    if do_diagonal:
        steps += _DIAGONAL
    if not steps:
        return torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
    out = torch.empty(vol.shape, dtype=torch.float32, device=vol.device)
    for i, step in enumerate(steps):
        if seam_period is not None and step[0] == 0:
            _launch(vol, img, out, out if i else None, step, sd, 0, W, seam_period, P1, P2,
                    "sgm_segment")
            segment_launches += 1
        else:
            _path(vol, img, out, step, sd, P1, P2, i > 0, "sgm")
    return out


@profiling.spanned("dispatch")
def sgm_aggregate_scan(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01, P2: float = 0.02,
                       do_reverse: bool = True, mask_mode: str = "left", scan_is_x: bool = False,
                       width: int | None = None, acc: torch.Tensor | None = None,
                       lane_offset: int | None = None, seam_period: int | None = None):
    """Both path directions along one axis of vol (D, S, N) on the card,
    chained through one output (``acc``, updated in place, when given).
    The row scans of a column shard (``lane_offset``, ``width``) or of a
    stacked batch (``seam_period``) are kernel 7 (``kt_sgm_segment``);
    whole rows or columns without either are kernel 1 (``kt_sgm_path``)."""
    global segment_launches
    op = "sgm_segment"
    _check_volume(vol, img, op)
    D, S, N = vol.shape
    sd = _plain._sd(mask_mode)
    width = N if width is None else int(width)
    offset = 0 if lane_offset is None else int(lane_offset)
    _plain._check_scan(S, N, scan_is_x, width, offset, seam_period)
    out = _output(vol, acc, op)
    variant = not scan_is_x and (lane_offset is not None or seam_period is not None
                                 or width != N)
    steps = _HORIZONTAL if scan_is_x else _VERTICAL
    for i, step in enumerate(steps if do_reverse else steps[:1]):
        accumulate = bool(i) or acc is not None
        if variant:
            _launch(vol, img, out, out if accumulate else None, step, sd, offset, width,
                    seam_period or 0, P1, P2, op)
            segment_launches += 1
        else:
            _path(vol, img, out, step, sd, P1, P2, accumulate, "sgm")
    return out


@profiling.spanned("dispatch")
def sgm_aggregate_block(vol: torch.Tensor, img: torch.Tensor, P1: float = 0.01,
                        P2: float = 0.02, mask_mode: str = "left", width: int | None = None,
                        seed: bool = True, carry_prev=None, carry_best=None, last_img=None,
                        lane_offset: int | None = None, acc: torch.Tensor | None = None,
                        reverse: bool = False):
    """One vertical direction over a row segment on the card (kernel 7):
    returns (Lr, added onto ``acc`` in place when given; final prev (D, N);
    final best (N,); the segment's last intensity row). See
    ``stereo.sgm.sgm_aggregate_block``."""
    global segment_launches
    op = "sgm_segment"
    _check_volume(vol, img, op)
    D, S, N = vol.shape
    sd = _plain._sd(mask_mode)
    width = N if width is None else int(width)
    out = _output(vol, acc, op)
    carry_in = None
    if not seed:
        carry_in = (_carry(carry_prev, "carry_prev", (D, N), vol.device),
                    _carry(carry_best, "carry_best", (N,), vol.device),
                    _carry(last_img, "last_img", (N,), vol.device))
    cout = (torch.empty((D, N), dtype=torch.float32, device=vol.device),
            torch.empty((N,), dtype=torch.float32, device=vol.device))
    _launch(vol, img, out, acc, (0, -1 if reverse else 1), sd,
            0 if lane_offset is None else int(lane_offset), width, 0, P1, P2, op,
            carry_in, cout)
    segment_launches += 1
    return out, cout[0], cout[1], img[0 if reverse else -1]


@profiling.spanned("dispatch")
def sgm_aggregate_diag_block(vol: torch.Tensor, img: torch.Tensor, carry_prev, carry_best,
                             carry_has, last_img, P1: float = 0.01, P2: float = 0.02,
                             mask_mode: str = "left", dx: int = 1, width: int | None = None,
                             acc: torch.Tensor | None = None, reverse: bool = False):
    """One diagonal direction over a row segment on the card (kernel 6):
    returns (Lr, added onto ``acc`` in place when given; final prev; final
    best; the segment's last intensity row; an all-ones has mask). See
    ``stereo.sgm.sgm_aggregate_diag_block``."""
    global diag_segment_launches
    op = "sgm_diag_segment"
    _check_volume(vol, img, op)
    if dx not in (1, -1):
        raise ValueError(f"dx must be +1 or -1, got {dx}")
    D, S, N = vol.shape
    sd = _plain._sd(mask_mode)
    width = N if width is None else int(width)
    out = _output(vol, acc, op)
    carry_in = (_carry(carry_prev, "carry_prev", (D, N), vol.device),
                _carry(carry_best, "carry_best", (N,), vol.device),
                _carry(last_img, "last_img", (N,), vol.device),
                _carry(carry_has, "carry_has", (N,), vol.device))
    cout = (torch.empty((D, N), dtype=torch.float32, device=vol.device),
            torch.empty((N,), dtype=torch.float32, device=vol.device))
    _launch(vol, img, out, acc, (dx, -1 if reverse else 1), sd, 0, width, 0, P1, P2, op,
            carry_in, cout)
    diag_segment_launches += 1
    return (out, cout[0], cout[1], img[0 if reverse else -1],
            torch.ones((N,), dtype=torch.float32, device=vol.device))
