"""The running-mean view update's roofline (``cost_volume_add_roofline.rate``):
its bound at the keyframe cell's shapes, and its reading of the program's
kernel spans."""
import json
from types import SimpleNamespace

import pytest

from portbench import spec

READER = spec.metric("cost_volume_add_roofline.rate")


def _config():
    return json.loads((spec.HERE / "configs" / "mvs-vga.json").read_text())


def test_bound_at_the_cell_is_the_bytes_of_n_s_and_the_images():
    """640x480, 128 disparities, rad 1: n and s read and written once
    (629.1 MB) and the two float32 images read once (2.5 MB) bind; the
    208 operations a cell (8.18 GFLOP) do not."""
    cfg = _config()
    assert (cfg["width"], cfg["height"], cfg["stereo"]["max_disp"], cfg["rad"]) == (640, 480,
                                                                                     128, 1)
    cells = 128 * 480 * 640
    nbytes = 4 * (4 * cells + 2 * 480 * 640)
    assert nbytes == 631_603_200 and cells * (28 + 20 * 9) == 8_178_892_800
    assert READER.bound_s(cfg) == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert READER.bound_s(cfg) == pytest.approx(0.18854e-3, rel=1e-4)
    # at rad 2 the 25 taps' 528 operations a cell (20.8 GFLOP) bind instead
    assert READER.bound_s(dict(cfg, rad=2)) == pytest.approx(cells * 528 / 67e12, rel=1e-12)


class _Span:
    def __init__(self, name, layer, device_ms):
        self.name, self.layer, self.device_ms = name, layer, device_ms


def _run(spans, monkeypatch):
    from kangaroo_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: spans)
    return SimpleNamespace(trace=SimpleNamespace(frames=60), config=_config())


def test_reads_the_kernel_spans_of_its_entry(monkeypatch):
    spans = [_Span("kt_cost_volume_add", "kernel", 0.5), _Span("kt_cost_volume_add", "kernel",
                                                                0.25),
             _Span("kt_dtam_run", "kernel", 6.0),
             _Span("stereo.costvolume.cost_volume_add", "stage", 1.0)]
    got = READER.read(_run(spans, monkeypatch))
    assert got == pytest.approx(100 * 2 * READER.bound_s(_config()) / 0.75e-3)


@pytest.mark.parametrize("spans", [[], [_Span("kt_dtam_run", "kernel", 6.0)],
                                   [_Span("kt_cost_volume_add", "kernel", None)]])
def test_says_nothing_without_a_timed_kernel_span(monkeypatch, spans):
    """The plain version launches no kernel (a parent without it), and a
    CPU run's spans hold no device time."""
    assert READER.read(_run(spans, monkeypatch)) is None
