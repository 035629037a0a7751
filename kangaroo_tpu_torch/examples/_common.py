"""Shared helpers for the demo programs (``examples/_common.py``).

The reference's examples open Pangolin GL windows (applications/examples/);
these offline equivalents write PNG/PXM/PLY artefacts instead. Each script is
a CLI with the reference app's tweakable Vars as flags, plus ``--device``
(the card by default).
"""
from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np
import torch


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the demos' ``--device`` flag."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: 'cuda' (the kernels) or 'cpu' (their plain "
                         "versions)")
    return ap


def out_dir() -> str:
    d = os.environ.get("KANGAROO_OUT", "out")
    os.makedirs(d, exist_ok=True)
    return d


def to_numpy(img) -> np.ndarray:
    return img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)


def finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def save_png(path: str, img) -> None:
    """Minimal PNG writer (grayscale or RGB uint8; other dtypes are
    normalised to their finite range) without external deps."""
    arr = to_numpy(img)
    if arr.dtype != np.uint8:
        a = arr.astype(np.float32)
        a = np.where(np.isfinite(a), a, 0.0)
        lo, hi = a.min(), a.max()
        arr = ((a - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    if arr.ndim == 2:
        color_type, raw = 0, arr[:, :, None]
    else:
        color_type, raw = 2, arr[..., :3]
    h, w = raw.shape[:2]
    lines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(lines)))
        f.write(chunk(b"IEND", b""))


def test_image(w=640, h=480, seed=0) -> np.ndarray:
    """Textured synthetic grayscale test image (float32 in [0, 255])."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (
        120
        + 60 * np.sin(x / 23.0)
        + 50 * np.cos(y / 17.0)
        + 25 * rng.standard_normal((h, w))
    )
    return np.clip(img, 0, 255).astype(np.float32)
