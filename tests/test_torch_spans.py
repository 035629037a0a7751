"""The program's span recorder (``kangaroo_tpu_torch/utils/profiling.py``) on
the CPU: off without a profiler, nesting and shared request ids under one,
host stamps on the profiler's clock, the spans of the stereo paths' layers,
and the launch counters by name. The card's cases (device times of the
spans, kernel spans against the counters) are in ``test_torch_cuda.py``."""
import statistics
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kangaroo_tpu_torch import backend
from kangaroo_tpu_torch.apps import stereo, stereo_sgm, synthetic
from kangaroo_tpu_torch.containers import Intrinsics
from kangaroo_tpu_torch.core import se3
from kangaroo_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _busy(seconds):
    """Work on the host for ``seconds`` (a thread woken from a sleep runs
    its next few microseconds slowly, which is not what a span measures)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        torch.ones(8, 8) @ torch.ones(8, 8)


@profiling.spanned("stage")
def _stage(x):
    return x + 1


def test_without_a_profiler_a_span_records_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span off made a range or an event")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with profiling.span("off", "entry") as opened:
        assert _stage(1) == 2
        backend.launch(lambda a: a - 3, 3, op="off")
    assert opened is None and profiling.spans() == []


def test_nesting_parents_requests_and_self_time():
    with _profile():
        with profiling.span("a", "entry") as a:
            with profiling.span("b", "stage") as b:
                with profiling.span("c", "dispatch") as c:
                    time.sleep(0.002)
                _stage(0)
            with profiling.span("d", "stage") as d:
                time.sleep(0.001)
        with profiling.span("e", "entry") as e:
            pass
    got = profiling.spans()
    assert [s.name for s in got] == ["c", "test_torch_spans._stage", "b", "d", "a", "e"]
    inner = got[1]
    assert (a.parent, b.parent, c.parent, d.parent, inner.parent, e.parent) == \
        (None, a.id, b.id, a.id, b.id, None)
    assert {s.request for s in (a, b, c, d, inner)} == {a.id} and e.request == e.id != a.id
    assert inner.layer == "stage" and c.layer == "dispatch"
    assert b.child_ns == (c.end_ns - c.start_ns) + (inner.end_ns - inner.start_ns)
    assert a.child_ns == (b.end_ns - b.start_ns) + (d.end_ns - d.start_ns)
    assert a.self_ms == pytest.approx(a.host_ms - b.host_ms - d.host_ms, abs=1e-9)
    assert c.self_ms == c.host_ms >= 2.0 and 0 < b.self_ms < b.host_ms
    assert all(s.start_ns <= s.end_ns for s in got) and a.start_ns <= b.start_ns
    assert all(s.device_ms is None for s in got)  # no CUDA: no events


def _clock_offsets() -> list[int]:
    """The 16 host stamps of 8 spans (4 entries, each around a stage of 1 ms
    of host work) against their ranges' own stamps on the profiler's clock:
    the absolute differences in ns."""
    with _profile() as prof:
        with profiling.span("warm-up", "entry"):
            pass
        for i in range(4):
            with profiling.span(f"clock{i}", "entry"):
                with profiling.span(f"inner{i}", "stage"):
                    _busy(0.001)
    ranges = {ev.name(): (ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(profiling.PREFIX)}
    spans = [s for s in profiling.spans() if s.name != "warm-up"]
    assert len(spans) == 8
    offsets = []
    for s in spans:
        start, end = ranges[profiling.PREFIX + s.name]
        offsets += [abs(s.start_ns - start), abs(s.end_ns - end)]
    return offsets


def _share_the_clock(offsets) -> bool:
    """Each stamp lies a return path from its range's: the median offset
    under 50 us and each under 500 us. A process descheduled between a
    range and its stamp, among several test processes, moves one offset,
    not the median."""
    return statistics.median(offsets) < 50_000 and max(offsets) < 500_000


def test_spans_share_the_profiler_clock():
    offsets = _clock_offsets()
    assert _share_the_clock(offsets), offsets


def test_a_spans_clock_1_ms_off_the_profilers_fails_the_check(monkeypatch):
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(time_ns=lambda: time.time_ns() + 1_000_000))
    offsets = _clock_offsets()
    assert not _share_the_clock(offsets), offsets


def test_launch_opens_a_kernel_span_and_checks_the_code():
    def kt_entry(x):
        return x

    with _profile():
        backend.launch(kt_entry, 0, op="demo")
        with pytest.raises(RuntimeError, match="demo: kernel launch failed with cudaError 7"):
            backend.launch(kt_entry, 7, op="demo")
    got = profiling.spans()
    assert [(s.name, s.layer) for s in got] == [("kt_entry", "kernel")] * 2


def test_the_store_is_capped_and_counts_what_it_drops(monkeypatch, tmp_path):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    with _profile():
        for _ in range(5):
            _stage(0)
    assert len(profiling.spans()) == 2 and profiling.spans_dropped() == 3
    with profiling.trace(str(tmp_path)):  # the exporter starts from an empty store
        assert profiling.spans() == [] and profiling.spans_dropped() == 0
        _stage(0)
    assert [s.name for s in profiling.spans()] == ["test_torch_spans._stage"]
    with pytest.raises(ValueError, match="layer"):
        profiling.spanned("frame")
    with _profile(), pytest.raises(ValueError, match="layer"):
        profiling.span("x", "frame")


def test_multi_view_cycle_records_its_entry_points_and_stages():
    key, _, track = synthetic.multiview_track(48, 32, 8, device="cpu")
    mvs = stereo.MultiViewStereo(Intrinsics.centered(43.2, 48, 32), 0.1,
                                 stereo.StereoConfig(max_disp=8, dtam_iterations=3))
    with _profile():
        mvs.reset(key.float(), se3.identity(device="cpu"), right=track[-1][0].float())
        for img, T in track[:3]:
            mvs.add(img.float(), T)
        mvs.solve()
    spans = profiling.spans()
    named = _by_name(spans)
    entry = [s.name for s in spans if s.layer == "entry"]
    app = "apps.stereo.MultiViewStereo."
    assert entry == [app + n for n in ("reset", "add", "add", "add", "volume", "solve")]
    (reset,), adds, (volume,), (solve,) = (named[app + n] for n in
                                           ("reset", "add", "volume", "solve"))
    (seed,) = named["stereo.costvolume.cost_volume_from_stereo"]
    views = named["stereo.costvolume.cost_volume_add"]
    (edge,) = named["stereo.costvolume.exponential_edge_weight"]
    assert seed.parent == reset.id and seed.layer == "stage"
    assert [v.parent for v in views] == [a.id for a in adds]
    assert volume.parent == solve.id and edge.parent == solve.id
    assert len({s.request for s in spans}) == 5  # reset, 3 adds, solve
    assert all(s.parent is None for s in (reset, *adds, solve))


def test_sgm_frame_records_census_and_its_volume():
    left, right, _ = synthetic.stereo_pair(48, 32, 8, device="cpu")
    with _profile():
        stereo_sgm.sgm_pipeline(left, right, stereo_sgm.SgmConfig(max_disp=8))
    named = _by_name(profiling.spans())
    (frame,) = named["apps.stereo_sgm.sgm_pipeline"]
    census = named["stereo.census.census"]
    (volume,) = named["stereo.census.census_cost_volume"]
    assert len(census) == 2 and frame.layer == "entry"
    assert all(s.layer == "stage" and s.parent == frame.id for s in (*census, volume))


def test_counts_name_every_launch_counter_and_reset_zeros_them():
    from kangaroo_tpu_torch.stereo import dtam_cuda, sgm_cuda

    assert list(profiling.counts()) == [
        "sgm", "sgm_8path", "sgm_segment", "sgm_diag_segment", "wta", "median", "lr_check",
        "rof", "tgv", "wta_sq", "dtam", "separable_fuse", "cost_volume_add", "census",
        "census_volume"]
    sgm_cuda.diagonal_launches += 3
    dtam_cuda.launches += 2
    got = profiling.counts()
    assert got["sgm_8path"] >= 3 and got["dtam"] >= 2
    profiling.reset_counts()
    assert set(profiling.counts().values()) == {0}
    assert sgm_cuda.diagonal_launches == 0 and dtam_cuda.launches == 0
