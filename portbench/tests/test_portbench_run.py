"""Whole runs of each cell at a tiny size on the CPU (the program's plain
versions): the result line keeps to the contract, a sound run is correct,
and a run with the timed path broken underneath, or with the plain
reference in bfloat16 put in the program's place, is not."""
import json

import pytest
import torch

from portbench import spec

CELLS = ["sgm-kitti.batch8", "mvs-vga.keyframe20"]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_prints_only_the_contract_keys(tiny_root, run_cell, cell):
    rc, res, err = run_cell(tiny_root, cell)
    assert rc == 0 and res is not None
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    e2e, _ = spec.cell_metrics(spec.benchmark(tiny_root), cell)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    for m in e2e:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = json.loads((tiny_root / "portbench" / "workloads" / f"{cell}.json").read_text())
    assert set(res["checks"]) == set(limits["limits"])
    # the numbers compared, each beside its limit, are stderr's last lines
    tail = err.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(tail, res["checks"].items()):
        assert line == f"{name} {c['value']!r} limit {c['limit']!r}"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_ranges_and_gives_a_breakdown(tiny_root, run_cell, cell):
    rc, res, _ = run_cell(tiny_root, cell, trace=1)
    assert rc == 0
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the idle gaps fall in the ranges the host was in
    assert res["breakdown"]["idle_gaps"] and res["metrics"]["idle_share.rate"]["value"] == 1.0
    assert "sgm_roofline.rate" not in res["metrics"]  # nothing to read, nothing said


# cells whose window ends with its trace on these seeds: a sample offset
# drawn from the seed below the stride (7 and 5) would be 5 and 4, past the
# trace's 4 and 3 units, and the run would keep nothing to compare
ENDS_WITH_ITS_TRACE = [("sgm-kitti.batch8", "batch8", 1883583489),
                       ("mvs-vga.keyframe20", "keyframe20", 2147483605)]


@pytest.mark.parametrize("cell,mix,seed", ENDS_WITH_ITS_TRACE)
def test_a_window_spent_by_its_trace_still_compares_an_answer(tiny_root, run_cell, cell, mix,
                                                              seed):
    """A ``--trace 1`` run given 0 seconds, with the cell's own sample and
    traced units: the window ends with its trace, and the run still
    compares the answers it kept, and is correct."""
    real = json.loads((spec.ROOT / "portbench" / "traffic" / f"{mix}.json").read_text())
    path = tiny_root / "portbench" / "traffic" / f"{mix}.json"
    tiny = json.loads(path.read_text())
    tiny["trace_units"] = real["trace_units"]
    path.write_text(json.dumps(tiny))
    rc, res, err = run_cell(tiny_root, cell, seed=seed, seconds=0, trace=1)
    per_unit = tiny["batch"] if "batch" in tiny else tiny["views"]
    assert rc == 0 and res["attempted"] == real["trace_units"] * per_unit  # the trace alone
    compared = int(err.split("compared ")[-1].split(" frames")[0])
    assert compared > 0 and res["correct"] is True and res["failed"] == 0
    assert all(c["value"] is not None and c["value"] <= c["limit"]
               for c in res["checks"].values())


def _block(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[..., 16:24, 24:32] = 1e3
    return out


def _sgm_answer_altered(mp):
    from kangaroo_tpu_torch.apps import stereo_sgm

    orig = stereo_sgm.sgm_pipeline_batched
    mp.setattr(stereo_sgm, "sgm_pipeline_batched", lambda *a, **k: _block(orig(*a, **k)))


def _sgm_half_batch(mp):
    from kangaroo_tpu_torch.apps import stereo_sgm

    orig = stereo_sgm.sgm_pipeline_batched

    def half(lefts, rights, cfg):
        h = len(lefts) // 2
        out = orig(lefts[:h], rights[:h], cfg)
        return torch.cat([out, out])

    mp.setattr(stereo_sgm, "sgm_pipeline_batched", half)


def _sgm_state_unchanged(mp):
    from kangaroo_tpu_torch.stereo import dispatch

    mp.setattr(dispatch, "semi_global_matching", lambda vol, img, *a, **k: vol.float())


def _mvs_state_unchanged(mp):
    from kangaroo_tpu_torch.stereo import costvolume

    mp.setattr(costvolume, "cost_volume_add", lambda n, s, *a, **k: (n, s))


def _mvs_answer_altered(mp):
    from kangaroo_tpu_torch.apps import stereo

    orig = stereo.MultiViewStereo.solve
    mp.setattr(stereo.MultiViewStereo, "solve", lambda self, *a, **k: _block(orig(self, *a, **k)))


def _mvs_half_views(mp):
    from kangaroo_tpu_torch.apps import stereo

    orig = stereo.MultiViewStereo.add
    calls = []

    def add(self, img, T):  # the mean taken over every other view
        calls.append(1)
        return orig(self, img, T) if len(calls) % 2 else (self.n, self.s)

    mp.setattr(stereo.MultiViewStereo, "add", add)


FAULTS = {
    "sgm-kitti.batch8": [_sgm_answer_altered, _sgm_half_batch, _sgm_state_unchanged],
    "mvs-vga.keyframe20": [_mvs_state_unchanged, _mvs_answer_altered, _mvs_half_views],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tiny_root, run_cell, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, res, _ = run_cell(tiny_root, cell)
    assert rc == 0 and res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(tiny_root, cell):
    """The plain reference in bfloat16 in the program's place fails a
    limit; the program on the same inputs meets every limit."""
    from portbench import readings

    out = readings.readings(cell, 2**31 + 11, True, torch.device("cpu"), tiny_root)
    limits = json.loads((tiny_root / "portbench" / "workloads" / f"{cell}.json").read_text())
    limits = limits["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items())
    assert any(out["control"][k] > v for k, v in limits.items())


def test_jax_loaded_by_the_comparison_withholds_the_result(tiny_root, run_cell, monkeypatch):
    """The look for JAX comes just before the output, so a module that the
    reference or a reader loads after the window stops the result too."""
    import sys

    from portbench.reference import mvs

    orig = mvs.keyframe

    def keyframe(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", object())
        return orig(*a, **k)

    monkeypatch.setattr(mvs, "keyframe", keyframe)
    rc, res, err = run_cell(tiny_root, "mvs-vga.keyframe20")
    assert rc != 0 and res is None and "jax" in err
