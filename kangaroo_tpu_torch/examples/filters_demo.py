"""Filtering examples: Anaglyph, BilateralFilter, GuidedFilter.

Offline equivalents of applications/examples/{Anaglyph,BilateralFilter,
GuidedFilter}.cpp (``examples/filters_demo.py``).
"""
from __future__ import annotations

import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--gs", type=float, default=2.0, help="bilateral spatial sigma")
    ap.add_argument("--gr", type=float, default=20.0, help="bilateral range sigma")
    ap.add_argument("--size", type=int, default=5, help="bilateral radius")
    ap.add_argument("--guided-rad", type=int, default=9)
    ap.add_argument("--guided-eps", type=float, default=1e-2)
    args = ap.parse_args(argv)

    from kangaroo_tpu_torch.apps import synthetic
    from kangaroo_tpu_torch.ops import bilateral, integral_image, viz

    dev = torch.device(args.device)
    out = _common.out_dir()
    left, right, _ = synthetic.stereo_pair(320, 240, 32, device=dev)

    ana = viz.make_anaglyph(left, right)
    _common.save_png(f"{out}/anaglyph.png", ana[..., :3])

    img = torch.from_numpy(_common.test_image(320, 240)).to(dev)
    bi = bilateral.bilateral(img, args.gs, args.gr, args.size)
    _common.save_png(f"{out}/bilateral.png", bi)

    gf = integral_image.guided_filter(img / 255.0, img / 255.0,
                                      args.guided_rad, args.guided_eps)
    _common.save_png(f"{out}/guided.png", gf)
    print(f"wrote anaglyph.png, bilateral.png, guided.png to {out}/")


if __name__ == "__main__":
    main()
