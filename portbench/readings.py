#!/usr/bin/env python3
"""The two readings that a cell's comparison limits are set between.

    python3 portbench/readings.py --workload <cell> --seeds <n> [<n> ...] [--control]

For each seed, in one process on the card: the cell's inputs and program as
a run builds them, as many units as a run's sample needs (no timed window),
the kept answers against the plain reference (the program's reading), and
with ``--control`` the reference in bfloat16 put in the program's place
(the control's reading, which the limits have to reject). One JSON line a
seed. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, control: bool, device, root: Path = ROOT) -> dict:
    """The program's (and the control's) numbers on ``seed``."""
    from portbench import spec

    cell = {w["name"]: w for w in spec.benchmark(root)["workloads"]}[workload]
    drv, _, _, check = spec.build(cell, seed, device, root / "portbench")
    for unit in range(drv.sample.last + 1):
        drv.run_unit(unit)
    drv.free()
    out = {"workload": workload, "seed": seed, "program": drv.check(check["limits"])[0]}
    if control:
        out["control"] = drv.control(check["limits"])[0]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings need the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.control, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
