"""The readers of the program's own spans in a traced CPU run: the host
metrics are read from the spans that the program recorded while the
profiler ran, and the readers that need the card say nothing."""
import pytest

from portbench import program_spans

CELLS = ["mvs-vga.keyframe20", "sgm-kitti.batch8"]
HOST = {"program_host_ms.rate", "stage_host_ms.rate"}
DEVICE = {"stage_device_ms.rate", "wrapper_host_us.rate", "dtam_kernel_roofline.rate"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_spans(tiny_root, run_cell, cell):
    rc, res, _ = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and res["correct"] is True
    for name in HOST:
        assert res["metrics"][name]["unit"] == "ms/frame"
        assert res["metrics"][name]["value"] > 0
    # the program's host time holds its stages' own time
    assert (res["metrics"]["program_host_ms.rate"]["value"]
            > res["metrics"]["stage_host_ms.rate"]["value"])
    assert not DEVICE & set(res["metrics"])  # nothing to read, nothing said


def test_untraced_run_reads_no_spans(tiny_root, run_cell):
    rc, res, _ = run_cell(tiny_root, "mvs-vga.keyframe20")
    assert rc == 0 and not (HOST | DEVICE) & set(res["metrics"])


class _Span:
    def __init__(self, id, parent, layer):
        self.id, self.parent, self.layer = id, parent, layer


def test_outermost_skips_spans_enclosed_by_their_layer():
    spans = [_Span(3, 2, "stage"), _Span(2, 1, "stage"), _Span(5, 4, "stage"),
             _Span(4, 1, "dispatch"), _Span(1, None, "entry"), _Span(6, None, "stage")]
    assert [s.id for s in program_spans.outermost(spans, "stage")] == [2, 5, 6]
