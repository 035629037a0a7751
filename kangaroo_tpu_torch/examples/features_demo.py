"""Feature detection example: FAST segment test, Harris, NMS.

Offline equivalent of applications/examples/Features.cpp
(``examples/features_demo.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--threshold", type=int, default=20)
    ap.add_argument("--min-segment", type=int, default=9)
    ap.add_argument("--nms-rad", type=int, default=2)
    ap.add_argument("--harris-thresh", type=float, default=1e4)
    args = ap.parse_args(argv)

    from kangaroo_tpu_torch.ops import features

    out = _common.out_dir()
    img = torch.from_numpy(_common.test_image(320, 240).astype(np.uint8)).to(args.device)

    seg = features.segment_test(img, args.threshold, args.min_segment)
    _common.save_png(f"{out}/fast.png", seg)

    score = features.harris_score(img)
    nms = features.non_maximal_suppression(score, args.nms_rad, args.harris_thresh)
    _common.save_png(f"{out}/harris_nms.png", nms)

    corners = features.get_indices(nms, 128)
    print(f"{len(corners)} Harris corners after NMS; wrote fast.png, harris_nms.png to {out}/")


if __name__ == "__main__":
    main()
