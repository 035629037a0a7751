"""The KITTI SGM cell in ``BENCHMARK.json``: the per-layer metrics that list
it have readers, the three that would read nothing there do not list it,
and the census rooflines (``census_roofline.rate``,
``census_volume_roofline.rate``): their bounds at the cell's shapes, and
their readings of the program's kernel spans."""
import json
from types import SimpleNamespace

import pytest

from portbench import spec

CELL = "sgm-kitti.batch8"
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
# the keyframe cell's kernels: nothing of them runs in the SGM cell
SILENT = {"dtam_roofline.rate", "dtam_kernel_roofline.rate", "cost_volume_add_roofline.rate"}
CENSUS = spec.metric("census_roofline.rate")
VOLUME = spec.metric("census_volume_roofline.rate")


def _load(kind, name):
    return json.loads((spec.HERE / kind / f"{name}.json").read_text())


def test_the_cell_is_in_the_manifest_with_its_configuration():
    (cell,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("sgm-kitti", "batch8", 1)
    (cfg,) = [c for c in BENCH["configs"] if c["name"] == "sgm-kitti"]
    assert cfg["reduced"] == [] and cfg["source"] == _load("configs", "sgm-kitti")["source"]


def test_every_metric_listing_the_cell_has_a_reader_and_the_silent_ones_do_not_list_it():
    listing = [m for m in BENCH["per_layer"] if CELL in m.get("workloads", ())]
    assert {m["name"] for m in listing} >= {"sgm_roofline.rate", "census_roofline.rate",
                                            "census_volume_roofline.rate", "idle_share.rate"}
    for m in listing:
        reader = spec.metric(m["name"])
        assert callable(reader.read) and reader.LAYER == m["layer"]
    for m in BENCH["per_layer"]:
        if m["name"] in SILENT:
            assert CELL not in m["workloads"]
    assert SILENT <= {m["name"] for m in BENCH["per_layer"]}


def test_census_bound_at_the_cell():
    """8 KITTI pairs, one side a call: each 1-byte pixel read once and its 4
    32-bit words written once (63.3 MB a side, 126.7 MB both)."""
    cfg, mix = _load("configs", "sgm-kitti"), _load("traffic", "batch8")
    side = 8 * 375 * 1242 * (1 + 4 * 4)
    assert 2 * side == 126_684_000
    assert CENSUS.bound_s(cfg, mix) == pytest.approx(side / 3.35e12, rel=1e-12)
    assert 2 * CENSUS.bound_s(cfg, mix) == pytest.approx(0.03782e-3, rel=1e-3)
    nine = dict(cfg, sgm=dict(cfg["sgm"], census_window="9x7"))
    assert CENSUS.bound_s(nine, mix) * 3.35e12 == pytest.approx(8 * 375 * 1242 * 9)


def test_volume_bound_at_the_cell():
    """The two census images read once at 16 bytes a pixel and the bfloat16
    volume of 128 disparities written once: 1,073.1 MB."""
    cfg, mix = _load("configs", "sgm-kitti"), _load("traffic", "batch8")
    nbytes = 8 * 375 * 1242 * (2 * 16 + 128 * 2)
    assert nbytes == 1_073_088_000
    assert VOLUME.bound_s(cfg, mix) == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert VOLUME.bound_s(cfg, mix) == pytest.approx(0.3203e-3, rel=1e-3)
    # a filtered volume stays float32
    guided = dict(cfg, sgm=dict(cfg["sgm"], guided_filter=True))
    assert VOLUME.bound_s(guided, mix) * 3.35e12 == pytest.approx(8 * 375 * 1242 * (32 + 512))


class _Span:
    def __init__(self, name, layer, device_ms):
        self.name, self.layer, self.device_ms = name, layer, device_ms


def _run(spans, monkeypatch):
    from kangaroo_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: spans)
    return SimpleNamespace(trace=SimpleNamespace(frames=32), config=_load("configs", "sgm-kitti"),
                           traffic=_load("traffic", "batch8"))


@pytest.mark.parametrize("reader,entry", [(CENSUS, "kt_census"), (VOLUME, "kt_census_volume")],
                         ids=["census", "volume"])
def test_reads_the_kernel_spans_of_its_entry(monkeypatch, reader, entry):
    spans = [_Span(entry, "kernel", 0.5), _Span(entry, "kernel", 0.25),
             _Span("kt_sgm_path", "kernel", 6.0), _Span("stereo.census.census", "stage", 1.0),
             _Span(entry, "dispatch", 2.0)]
    run = _run(spans, monkeypatch)
    got = reader.read(run)
    assert got == pytest.approx(100 * 2 * reader.bound_s(run.config, run.traffic) / 0.75e-3)


@pytest.mark.parametrize("reader,entry", [(CENSUS, "kt_census"), (VOLUME, "kt_census_volume")],
                         ids=["census", "volume"])
@pytest.mark.parametrize("kept", ["none", "other kernels", "no device time"])
def test_says_nothing_without_a_timed_kernel_span(monkeypatch, reader, entry, kept):
    """The plain versions launch no kernel (a parent without them), and a CPU
    run's spans hold no device time."""
    spans = {"none": [], "other kernels": [_Span("kt_sgm_path", "kernel", 6.0)],
             "no device time": [_Span(entry, "kernel", None)]}[kept]
    assert reader.read(_run(spans, monkeypatch)) is None
