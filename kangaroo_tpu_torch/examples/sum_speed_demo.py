"""Normal-equation reduction micro-benchmark.

Offline equivalent of applications/examples/CudaSumSpeed.cpp:26-35
(``examples/sum_speed_demo.py``), which times the LeastSquaresSystem<float,6>
block reduction (SumSpeedTest, cu_model_refinement.cu:708-733): here
``solvers.lss.reduce_system`` timed by ``utils.timing.time_fn_stats`` (CUDA
events on the card, the host clock on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _common


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("--iters", type=int, default=2000,
                    help="calls a measurement (three measurements)")
    args = ap.parse_args(argv)

    from kangaroo_tpu_torch.solvers.lss import reduce_system
    from kangaroo_tpu_torch.utils.timing import time_fn_stats

    dev = torch.device(args.device)
    H, W = 480, 640
    rng = np.random.default_rng(0)
    J = torch.from_numpy(rng.normal(size=(H, W, 6)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.random((H, W)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((H, W)) > 0.1).to(dev)

    f = lambda J, y, w, v: reduce_system(J, y, w, v).JTJ  # noqa: E731
    stats = time_fn_stats(f, J, y, w, valid, iters=args.iters)
    dt = stats["median"]
    n = H * W
    print(f"LSS<float,6> reduction over {n} obs: {1e3 * dt:.3f} ms "
          f"({n / dt / 1e9:.2f} Gobs/s; min {1e3 * stats['min']:.3f}, "
          f"max {1e3 * stats['max']:.3f} ms, {args.device})")
    s = reduce_system(J, y, w, valid)
    print(f"obs={float(s.obs):.0f} rmse={float(s.rmse()):.4f}")
    return stats


if __name__ == "__main__":
    main()
