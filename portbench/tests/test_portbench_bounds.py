"""The rooflines' arithmetic at the cells' shapes, and the reduction of a
profile to what the per-layer readers read."""
import json
from types import SimpleNamespace

import pytest
import torch

from portbench import peaks, spec, trace

CONFIGS = spec.HERE / "configs"


def _load(kind, name):
    return json.loads((spec.HERE / kind / f"{name}.json").read_text())


def test_sgm_bound_at_the_cell():
    """8 KITTI pairs at 128 disparities: the bf16 volume (953.9 MB), the
    intensity (14.9 MB) and the float32 aggregate (1,907.7 MB), once."""
    reader = spec.metric("sgm_roofline.rate")
    cfg, mix = _load("configs", "sgm-kitti"), _load("traffic", "batch8")
    pixels = 8 * 375 * 1242
    assert pixels * (128 * 2 + 4 + 128 * 4) == 2_876_472_000
    assert reader.bound_s(cfg, mix) == pytest.approx(2_876_472_000 / 3.35e12, rel=1e-12)
    assert reader.bound_s(cfg, mix) == pytest.approx(0.8586e-3, rel=1e-3)


def test_dtam_bound_at_the_cell():
    """640x480, 128 disparities, 80 iterations: 23.2 GFLOP bind, not the
    volume's bytes; at 64 disparities and 50 iterations the count is the
    kernel table's 7.62 GFLOP."""
    reader = spec.metric("dtam_roofline.rate")
    cfg = _load("configs", "mvs-vga")
    flops = 80 * 640 * 480 * (7 * 128 + 48)
    assert flops == 23_199_744_000
    assert reader.bound_s(cfg) == pytest.approx(flops / 67e12, rel=1e-12)
    small = {"height": 480, "width": 640, "stereo": {"max_disp": 64, "dtam_iterations": 50}}
    assert reader.bound_s(small) * 67e12 == pytest.approx(7.6186e9, rel=1e-4)


def test_least_seconds_takes_the_binding_side():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


class Ev:
    """A stand-in of the profiler's events (of a PyTorch that reports each
    event's activity type)."""

    def __init__(self, name, s, e, cuda=False, corr=0, kind="", annot=False):
        self._name, self._s, self._e, self._corr, self._kind, self._annot = (
            name, s, e, corr, kind, annot)
        self._dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._corr

    def activity_type(self):
        return self._kind

    def is_user_annotation(self):
        return self._annot


class EvUntyped(Ev):
    """The events of a PyTorch that reports no activity type."""

    activity_type = None


@pytest.mark.parametrize("ev", [Ev, EvUntyped], ids=["typed", "untyped"])
def test_reduce_attributes_device_work_to_the_host_range_that_launched_it(ev):
    Ev = ev
    P = trace.PREFIX
    events = [
        Ev(P + "window", 0, 1300),
        Ev(P + "batch", 10, 900),
        Ev(P + "stereo.census.census", 20, 100),
        Ev("cudaLaunchKernel", 30, 32, corr=1),
        Ev("cudaLaunchKernel", 40, 42, corr=2),
        Ev(P + "stereo.dispatch.semi_global_matching", 200, 300),
        Ev("cuLaunchKernel", 210, 212, corr=3),
        Ev("cudaMemcpyAsync", 400, 410, corr=99),
        # on the card: two kernels of census (the second after the range
        # closed on the host), one of the aggregation, a copy launched in the
        # batch outside the program's ranges, and the card's mirror of a range
        Ev("census_k", 50, 150, cuda=True, corr=1, kind="kernel"),
        Ev("census_k", 150, 250, cuda=True, corr=2, kind="kernel"),
        Ev("sgm_k", 300, 500, cuda=True, corr=3, kind="kernel"),
        Ev("Memcpy DtoD", 600, 650, cuda=True, corr=99, kind="gpu_memcpy"),
        Ev(P + "batch", 10, 900, cuda=True, kind="gpu_user_annotation"),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))
    t = trace.reduce(prof, "window", trace.Trace(window_s=0.0, frames=8))
    assert t.window_s == pytest.approx(1.3e-6)
    assert t.busy_s == pytest.approx((200 + 200 + 50) * 1e-9)
    assert t.kernels == 3 and len(t.ops) == 4
    assert t.device_s({"stereo.census.census"}) == pytest.approx(200e-9)
    assert t.device_s({"stereo.dispatch.semi_global_matching"}) == pytest.approx(200e-9)
    assert t.device_s({"batch"}) == pytest.approx(50e-9)  # the copy, launched inside the batch
    assert t.calls == {"batch": 1, "stereo.census.census": 1,
                       "stereo.dispatch.semi_global_matching": 1}
    # idle: 0-50 (census open at its middle), 250-300 (the aggregation),
    # 500-600 (the batch), 650-1300 (its middle after the batch: the loop)
    assert t.idle == pytest.approx({"stereo.census.census": 50e-9,
                                    "stereo.dispatch.semi_global_matching": 50e-9,
                                    "batch": 100e-9, trace.HARNESS: 650e-9})
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["census_k", pytest.approx(200e-9)]
    assert len(bd["device_ops"]) == 3 and bd["idle_gaps"][0][0] == trace.HARNESS
    run = SimpleNamespace(trace=t, config=_load("configs", "sgm-kitti"),
                          traffic=_load("traffic", "batch8"))
    assert spec.metric("idle_share.rate").read(run) == pytest.approx(1 - 450 / 1300)
    assert spec.metric("launches_per_frame.rate").read(run) == pytest.approx(3 / 8)
    assert spec.metric("cost_volume_ms.rate").read(run) == pytest.approx(200e-9 * 1e3 / 8)
    sgm = spec.metric("sgm_roofline.rate").read(run)
    assert sgm == pytest.approx(100 * spec.metric("sgm_roofline.rate").bound_s(
        run.config, run.traffic) / 200e-9)
    assert spec.metric("dtam_roofline.rate").read(run) is None  # nothing to read
