#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``kangaroo_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The run makes its inputs from the seed (``data/``), builds the program's
objects and warms up every shape of the cell's traffic (set-up), then runs
the cell's driver (``drivers/<driver>.py``, named by the cell's traffic mix)
closed loop for ``--seconds``: whole units (a batch, a keyframe cycle), the
last one ending synchronised after the window's time is up. After the window
it frees the program's state and compares the answers it kept with the plain
reference (``reference/``). It prints no result if JAX or the JAX package
was loaded at any point up to the output.

It prints the comparison's numbers, each beside its limit, as the last lines
of standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last. Which
metrics a cell reports is read from ``BENCHMARK.json``; each metric is read
by ``metrics/<name>.py``.

A ``--trace 1`` run profiles the first ``trace_units`` units of the window
with ``torch.profiler`` (``trace.py``), the program's layers inside ranges
that this benchmark opens, and runs the rest of the window untraced.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the JAX package and JAX itself, by top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "kangaroo_tpu")
# kernel caches of the program's libraries, at fixed paths inside the checkout
CACHE = ROOT / "_portbench_cache"


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _say(*lines) -> None:
    print(*lines, sep="\n", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of the loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None, device=None, root: Path = ROOT) -> int:
    """Run the cell; return the exit code. ``device`` and ``root`` (the
    checkout whose ``BENCHMARK.json`` and benchmark files to read) are for
    the tests: the command line always asks for the card."""
    args = _parse(argv)
    from portbench import spec

    base = root / "portbench"
    bench = spec.benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        _say(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[args.workload]

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            _say(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                 f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    cuda = device.type == "cuda"

    e2e, layer = spec.cell_metrics(bench, cell["name"])
    wanted = layer if args.trace else e2e
    readers = {m["name"]: spec.metric(m["name"], base) for m in wanted}
    drv, cfg, mix, check = spec.build(cell, args.seed, device, base)
    drv.warmup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    latencies: list[float] = []
    unit = 0
    traced = None
    start = time.perf_counter()
    if args.trace:
        from portbench import trace

        targets = {}
        for reader in readers.values():
            targets.update(getattr(reader, "RANGES", {}))
        with trace.ranges(targets), trace.profiler() as prof:
            with torch.profiler.record_function(trace.PREFIX + "window"):
                for _ in range(mix["trace_units"]):
                    latencies += drv.run_unit(unit)
                    unit += 1
        traced = trace.Trace(window_s=0.0, frames=unit * drv.frames_per_unit)
    while unit == 0 or time.perf_counter() - start < args.seconds:
        latencies += drv.run_unit(unit)
        unit += 1
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    if traced is not None:
        trace.reduce(prof, "window", traced)
        del prof

    drv.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = check["limits"]
    numbers, n_checked, n_failed = drv.check(limits)
    # a number that could not be read (nothing kept) is null and fails
    numbers = {k: v if math.isfinite(v) else None for k, v in numbers.items()}
    correct = n_checked > 0 and all(numbers[k] is not None and numbers[k] <= v
                                    for k, v in limits.items())

    run = SimpleNamespace(frames=unit * drv.frames_per_unit, window_s=window_s,
                          latencies_ms=latencies, setup_s=setup_s, trace=traced, config=cfg,
                          traffic=mix)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": unit * drv.frames_per_unit,
              "failed": n_failed if n_checked else unit * drv.frames_per_unit,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    leaked = forbidden_modules()
    if leaked:
        _say(f"the run loaded {', '.join(leaked)}: the benchmark must not import JAX or the "
             "JAX package")
        return 3
    _say(f"compared {n_checked} frames of {result['attempted']}, {n_failed} over a limit",
         *(f"{k} {numbers[k]!r} limit {v!r}" for k, v in limits.items()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
