"""PXM (PGM/PPM + volume extension) reader and writer (``kangaroo_tpu/io/pxm.py``).

The reference's checkpoint format: binary P5 (grey) / P6 (rgb) images,
volumes as a P5/P6 header with an extra depth line, and the stereo app's
"P7" float32 depth maps (.pdm). Host-side IO on NumPy arrays (images
(H, W[, C]), volumes (D, H, W[, C])); ``save_tsdf``/``load_tsdf`` take and
give the port's ``TsdfVolume``. A ".gz" path is gzip-compressed.
"""
from __future__ import annotations

import gzip
import os

import numpy as np
import torch

from ..containers.bbox import BoundingBox
from ..containers.volume import TsdfVolume

_MAGIC_FOR_CHANNELS = {1: "P5", 3: "P6"}


def _channels(magic: str) -> int:
    if magic == "P5":
        return 1
    if magic == "P6":
        return 3
    raise ValueError(f"unsupported PXM magic {magic!r}")


def _dtype_for_maxval(maxval: int):
    if maxval <= 255:
        return np.uint8
    if maxval <= 65535:
        return np.dtype(">u2")  # PGM 16-bit is big-endian
    raise ValueError(f"unsupported maxval {maxval}")


def _maxval_for_dtype(dtype) -> int:
    dtype = np.dtype(dtype)
    if dtype == np.uint8:
        return 255
    if dtype in (np.dtype("<u2"), np.dtype(">u2"), np.dtype(np.uint16)):
        return 65535
    if dtype == np.float32:
        # The reference writes raw float data with maxval 255 for float images
        # (SavePPM.h SavePXM<float>); we keep maxval but tag via extension.
        return 255
    raise ValueError(f"unsupported dtype {dtype}")


def save_pxm(path: str, img: np.ndarray) -> None:
    """Save a 2D image (SavePXM, SavePPM.h:24-48). float32 data is written raw."""
    img = np.ascontiguousarray(img)
    c = 1 if img.ndim == 2 else img.shape[2]
    magic = _MAGIC_FOR_CHANNELS[c]
    h, w = img.shape[:2]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(f"{magic}\n{w} {h}\n{_maxval_for_dtype(img.dtype)}\n".encode())
        if img.dtype == np.float32:
            f.write(img.astype("<f4").tobytes())
        elif img.dtype == np.uint16:
            f.write(img.astype(">u2").tobytes())
        else:
            f.write(img.astype(np.uint8).tobytes())


def save_volume(path: str, vol: np.ndarray) -> None:
    """Save a (D, H, W[, C]) volume (SavePXM volume variant, SavePPM.h:52-78).

    Header: magic, "w h", "d", maxval — matching the reference's extra depth
    line before maxval.
    """
    vol = np.ascontiguousarray(vol)
    c = 1 if vol.ndim == 3 else vol.shape[3]
    magic = _MAGIC_FOR_CHANNELS[c]
    d, h, w = vol.shape[:3]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(f"{magic}\n{w} {h}\n{d}\n{_maxval_for_dtype(vol.dtype)}\n".encode())
        if vol.dtype == np.float32:
            f.write(vol.astype("<f4").tobytes())
        else:
            f.write(vol.tobytes())


def save_pdm(path: str, depth: np.ndarray) -> None:
    """Save a float32 depth map in the stereo app's binary "P7" .pdm format
    (applications/stereo/main.cpp:404-410): "P7", "w h", the uint32 sentinel
    maxval 4294967295, then raw little-endian float32 rows."""
    depth = np.ascontiguousarray(np.asarray(depth, np.float32))
    h, w = depth.shape
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(f"P7\n{w} {h}\n4294967295\n".encode())
        f.write(depth.astype("<f4").tobytes())


def load_pdm(path: str) -> np.ndarray:
    """Inverse of :func:`save_pdm` (the reference only ever writes .pdm)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = _read_token(f).decode()
        if magic != "P7":
            raise ValueError(f"not a P7 .pdm file: magic {magic!r}")
        w = int(_read_token(f))
        h = int(_read_token(f))
        _read_token(f)  # maxval sentinel (4294967295)
        raw = f.read()
    return np.frombuffer(raw, "<f4", count=w * h).reshape(h, w).copy()


def _read_token(f) -> bytes:
    """Read one whitespace-delimited token, skipping '#' comments."""
    tok = b""
    while True:
        ch = f.read(1)
        if not ch:
            break
        if ch == b"#":
            while ch not in (b"\n", b""):
                ch = f.read(1)
            continue
        if ch.isspace():
            if tok:
                break
            continue
        tok += ch
    return tok


def load_pxm(path: str, dtype=None) -> np.ndarray:
    """Load a PGM/PPM image (LoadPXM, SavePPM.h:82-120)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = _read_token(f).decode()
        c = _channels(magic)
        w = int(_read_token(f))
        h = int(_read_token(f))
        maxval = int(_read_token(f))
        raw = f.read()
    if dtype == np.float32:
        data = np.frombuffer(raw, "<f4", count=w * h * c)
    else:
        data = np.frombuffer(raw, _dtype_for_maxval(maxval), count=w * h * c)
        if data.dtype.byteorder == ">":
            data = data.astype(np.uint16)
    shape = (h, w) if c == 1 else (h, w, c)
    return data.reshape(shape).copy()


def load_volume(path: str, dtype=np.float32) -> np.ndarray:
    """Load a volume saved by :func:`save_volume` / the reference's SavePXM."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = _read_token(f).decode()
        c = _channels(magic)
        w = int(_read_token(f))
        h = int(_read_token(f))
        d = int(_read_token(f))
        maxval = int(_read_token(f))
        raw = f.read()
    if dtype == np.float32:
        data = np.frombuffer(raw, "<f4", count=w * h * d * c)
    else:
        data = np.frombuffer(raw, _dtype_for_maxval(maxval), count=w * h * d * c)
    shape = (d, h, w) if c == 1 else (d, h, w, c)
    return data.reshape(shape).copy()


def save_tsdf(path: str, vol) -> None:
    """Dump a TsdfVolume as an interleaved (val, w) float volume, the layout
    of the reference's BoundedVolume<SDF_t> dumps, with its box corners
    beside it in ``path + ".bbox.npy"``."""
    val = vol.val.detach().cpu().numpy().astype(np.float32)
    wgt = vol.weight.detach().cpu().numpy().astype(np.float32)
    inter = np.stack([val, wgt], axis=-1)  # (D, H, W, 2)
    d, h, w = val.shape
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(f"P5\n{w * 2} {h}\n{d}\n255\n".encode())
        f.write(inter.astype("<f4").tobytes())
    meta = np.stack([vol.bbox.lo.detach().cpu().numpy(), vol.bbox.hi.detach().cpu().numpy()])
    np.save(path + ".bbox.npy", meta)


def load_tsdf(path: str, device="cuda"):
    """Inverse of :func:`save_tsdf`: a TsdfVolume on ``device`` (the card
    unless the caller asks for another device); the default box when the
    ``.bbox.npy`` beside it is missing."""
    inter = load_volume(path, np.float32)  # (D, H, 2W)
    d, h, w2 = inter.shape
    inter = inter.reshape(d, h, w2 // 2, 2)
    meta_path = path + ".bbox.npy"
    if os.path.exists(meta_path):
        meta = np.load(meta_path)
        bbox = BoundingBox.create(meta[0], meta[1], device=device)
    else:
        bbox = BoundingBox.create(device=device)
    planes = (np.ascontiguousarray(inter[..., k]) for k in range(2))
    return TsdfVolume(*(torch.from_numpy(p).to(device) for p in planes), bbox)
