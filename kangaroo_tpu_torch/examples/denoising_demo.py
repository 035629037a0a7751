"""Variational examples: ROF/TGV denoising, deconvolution, inpainting.

Offline equivalents of applications/examples/{Denoising,Deconvolution,
InpaintingUsingDenoising}.cpp (``examples/denoising_demo.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--noise", type=float, default=0.15)
    ap.add_argument("--lam", type=float, default=8.0)
    ap.add_argument("--iterations", type=int, default=200)
    args = ap.parse_args(argv)

    from kangaroo_tpu_torch.ops.convolution import convolve
    from kangaroo_tpu_torch.variational import deconvolution, rof, tgv

    dev = torch.device(args.device)
    out = _common.out_dir()
    rng = np.random.default_rng(0)
    clean = torch.from_numpy(_common.test_image(320, 240)).to(dev) / 255.0
    noise = rng.normal(0, args.noise, tuple(clean.shape)).astype(np.float32)
    noisy = clean + torch.from_numpy(noise).to(dev)
    _common.save_png(f"{out}/noisy.png", noisy)

    u_rof = rof.denoise(noisy, lam=args.lam, iterations=args.iterations)
    _common.save_png(f"{out}/denoised_rof.png", u_rof)

    u_tgv = tgv.denoise(noisy, sigma=0.29, tau=0.29, delta=0.05,
                        iterations=args.iterations)
    _common.save_png(f"{out}/denoised_tgv.png", u_tgv)

    k = torch.ones((7, 7), dtype=torch.float32, device=dev)
    blurry = convolve(clean, k)
    u_dec = deconvolution.deconvolve(blurry, k, iterations=args.iterations)
    _common.save_png(f"{out}/blurry.png", blurry)
    _common.save_png(f"{out}/deconvolved.png", u_dec)

    mask = torch.from_numpy((rng.random(tuple(clean.shape)) > 0.5).astype(np.float32)).to(dev)
    corrupted = clean * mask
    u_inp = deconvolution.inpaint(corrupted, mask, iterations=args.iterations)
    _common.save_png(f"{out}/corrupted.png", corrupted)
    _common.save_png(f"{out}/inpainted.png", u_inp)
    print(f"wrote denoising/deconvolution/inpainting results to {out}/")


if __name__ == "__main__":
    main()
