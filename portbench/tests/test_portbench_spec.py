"""BENCHMARK.json against the benchmark's rules, and the harness finding a
cell, a configuration and a metric by their files alone."""
import json
import re
import shutil

import pytest
import torch

from portbench import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"[^\t\n]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")


def test_top_level_keys_command_and_paths():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for word in BENCH["command"]:
        assert LINE.fullmatch(word) and not word.startswith("/") and ".." not in word
    named = [w for w in BENCH["command"] if (ROOT / w).exists()]
    assert named and all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in named)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_and_unit_keeps_the_character_rules():
    spec.benchmark()  # raises on a broken name or unit
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME.fullmatch(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.fullmatch(m["unit"]), m
    for bad in ("has space", "a,b", "a/b", ".dot", "x" * 65, "μs"):
        with pytest.raises(spec.SpecError):
            spec.check_name(bad, "test")
    for bad in ("tokens per second", "", "μs", "x" * 17):
        with pytest.raises(spec.SpecError):
            spec.check_unit(bad, "test")


def test_configs_cells_and_metrics_keep_the_contract():
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert 1 <= len(configs) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and LINE.fullmatch(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        # the cell's files name neither its configuration nor its mix again
        check = spec.workload(w["name"])
        assert set(check) >= {"sample_stride", "sample_count", "limits"}
        assert not set(check) & {"name", "config", "traffic", "driver", "chips", "why"}
        mix = spec.traffic(w["traffic"])
        assert (ROOT / "portbench" / "drivers" / f"{mix['driver']}.py").exists()
        assert not set(mix) & {"name", "config", "chips", "why", "limits"}
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.fullmatch(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        reader = spec.metric(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (m["unit"], m["layer"], m["moves"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        got, layer = spec.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2 and layer
        for m in layer:  # a per-layer metric moves a metric its cells report
            assert m["moves"] in {g["name"] for g in got}
    for m in BENCH["end_to_end"]:
        reader = spec.metric(m["name"])
        assert reader.UNIT == m["unit"] and reader.LAYER is None


def test_every_file_under_the_folder_has_a_name_of_the_allowed_characters():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.fullmatch(rel), rel
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]*", path.name), rel


def test_files_dropped_in_are_found_without_an_edit(tiny_root, run_cell):
    """A new configuration, cell and metric: files and entries only."""
    base = tiny_root / "portbench"
    cfg = json.loads((base / "configs" / "sgm-kitti.json").read_text())
    cfg.update(name="sgm-small", width=80)
    (base / "configs" / "sgm-small.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "batch8.json").read_text())
    mix.update(batch=1, pool=3)
    (base / "traffic" / "stream.json").write_text(json.dumps(mix))
    shutil.copy(base / "workloads" / "sgm-kitti.batch8.json",
                base / "workloads" / "sgm-small.stream.json")
    shutil.copy(base / "metrics" / "frames_per_s.py", base / "metrics" / "pairs_per_s.py")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sgm-small", "source": cfg["source"],
                             "file": "portbench/configs/sgm-small.json", "reduced": [],
                             "why": "a smaller frame"})
    bench["workloads"].append({"name": "sgm-small.stream", "config": "sgm-small",
                               "traffic": "stream", "chips": 1, "why": "one pair a call"})
    bench["end_to_end"].append({"name": "pairs_per_s", "unit": "frames/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["sgm-small.stream"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, _ = run_cell(tiny_root, "sgm-small.stream")
    assert rc == 0 and res["correct"] is True
    assert {"frames_per_s", "pairs_per_s", "setup_s"} == set(res["metrics"])
    assert res["metrics"]["pairs_per_s"] == res["metrics"]["frames_per_s"]


def test_a_run_without_the_card_prints_no_result(capsys):
    from portbench import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


CELL_MIX = {"mvs-vga.keyframe20": "keyframe20", "sgm-kitti.batch8": "batch8"}


@pytest.mark.parametrize("cell", sorted(CELL_MIX))
def test_the_kept_units_cover_distinct_inputs_past_the_pool_s_wrap(cell):
    """Each cell keeps unit 0 and every stride-th unit after it: units of
    distinct inputs, some after the pool has wrapped once."""
    from portbench import compare

    check = spec.workload(cell)
    mix = spec.traffic(CELL_MIX[cell])
    period = mix["pool"] // mix.get("batch", 1)
    stride, count = check["sample_stride"], check["sample_count"]
    sample = compare.Sample(stride, count)
    kept = [u for u in range(200) if sample.keeps(u)]
    assert kept == [k * stride for k in range(count)] and sample.last == kept[-1]
    assert len({u % period for u in kept}) == len(kept) and kept[-1] >= period


def _cheap_inputs(monkeypatch):
    """Stand-ins of the generators, of the right shapes and types: the
    sample does not depend on what the inputs hold."""
    import numpy as np

    from portbench.data import synthetic

    def pair(w, h, d, seed):
        return np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8), np.zeros((h, w), np.float32)

    def track(w, h, d, K, baseline, views, seed, device):
        img = torch.zeros(h, w, dtype=torch.uint8, device=device)
        return img, img, img.expand(views, h, w), synthetic.track_poses(views, seed)

    monkeypatch.setattr(synthetic, "stereo_pair", pair)
    monkeypatch.setattr(synthetic, "handheld_track", track)


@pytest.mark.parametrize("cell", sorted(CELL_MIX))
def test_every_run_keeps_an_answer_whatever_the_seed(tiny_root, monkeypatch, cell):
    """Over 1,000 seeds, the first unit that the cell's driver keeps, with
    the cell's own sample, is one that every run reaches: unit 0, which an
    untraced window runs however soon its seconds are spent, and which a
    traced run traces first."""
    import random

    _cheap_inputs(monkeypatch)
    cells = {w["name"]: w for w in spec.benchmark(tiny_root)["workloads"]}
    mix = spec.traffic(CELL_MIX[cell], tiny_root / "portbench")
    # the units that an untraced run of 0 s and a traced run both reach
    reached = set(range(1)) & set(range(mix["trace_units"]))
    check = spec.workload(cell, tiny_root / "portbench")
    draw = random.Random(5)
    seeds = [1883583489, 2**31 + 2**30] + [draw.randrange(2**31 + 2**30) for _ in range(998)]
    for seed in seeds:
        drv, *_ = spec.build(cells[cell], seed, torch.device("cpu"), tiny_root / "portbench")
        kept = [u for u in range(drv.sample.last + 1) if drv.sample.keeps(u)]
        assert kept[0] in reached and len(kept) == check["sample_count"], seed
