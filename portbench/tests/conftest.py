"""Fixtures of the benchmark's CPU tests: the checkout on ``sys.path`` and a
copy of the benchmark's files at a tiny size."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell at a size the CPU runs in seconds: the same settings, paths,
# samples and limits, fewer pixels, disparities, frames and iterations
TINY = {
    "sgm-kitti": ({"width": 64, "height": 48}, {"max_disp": 16}),
    "mvs-vga": ({"width": 64, "height": 48, "focal": 57.6},
                {"max_disp": 16, "dtam_iterations": 10}),
}
TINY_TRAFFIC = {
    "batch8": {"batch": 2, "pool": 4, "trace_units": 1},
    "keyframe20": {"views": 4, "pool": 2, "trace_units": 1},
}


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data, indent=1))


# the entries that put the SGM cell into BENCHMARK.json; its files wait in
# portbench/ until the card paces it
SGM_CELL = "sgm-kitti.batch8"
SGM_WHY = ("stacks of 8 KITTI pairs (1242x375, 128 disparities) through sgm_pipeline_batched, "
           "closed loop: census, the stacked volume, the seamed aggregation, the tail; bypasses "
           "cost_volume_add and DTAM")


def add_sgm_cell(bench: dict) -> dict:
    """``bench`` with the SGM cell, its configuration and its metrics."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "sgm-kitti.json").read_text())
    bench["configs"].append({"name": "sgm-kitti", "source": cfg["source"],
                             "file": "portbench/configs/sgm-kitti.json", "reduced": [],
                             "why": "KITTI-sized SGM: census, the bf16 volume, the seamed "
                                    "aggregation, subpixel WTA, median, LR check"})
    bench["workloads"].append({"name": SGM_CELL, "config": "sgm-kitti", "traffic": "batch8",
                               "chips": 1, "why": SGM_WHY})
    for m in bench["per_layer"]:
        if m["name"] != "dtam_roofline.rate":
            m["workloads"] = m["workloads"] + [SGM_CELL]
    bench["per_layer"].append({"name": "sgm_roofline.rate", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "Kernels (csrc/sgm_path.cu)",
                               "moves": "frames_per_s", "workloads": [SGM_CELL]})
    return bench


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ whose cells are tiny, with the
    SGM cell added as a later change would add it."""
    bench = add_sgm_cell(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (top, settings) in TINY.items():
        def shrink(c, top=top, settings=settings):
            c.update(top)
            (c.get("sgm") or c["stereo"]).update(settings)
        _edit(tmp_path / "portbench" / "configs" / f"{name}.json", shrink)
    for name, traffic in TINY_TRAFFIC.items():
        _edit(tmp_path / "portbench" / "traffic" / f"{name}.json",
              lambda w, traffic=traffic: w.update(traffic))
    return tmp_path


@pytest.fixture
def run_cell(capsys):
    """Run a cell of a copy on the CPU; returns (exit code, last stdout line
    parsed or None, stderr)."""
    import torch

    from portbench import run

    def go(root: Path, workload: str, seed: int = 2**31 + 7, seconds: float = 0.5,
           trace: int = 0):
        rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=torch.device("cpu"), root=root)
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err

    return go
