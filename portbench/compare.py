"""What the drivers share: the sample of answers kept for the comparison,
the comparison's numbers, and the clock of a frame's latency."""
from __future__ import annotations

import time

import torch


class Sample:
    """Which units of the window keep their answers for the comparison:
    unit 0 and every ``stride``-th unit after it, ``count`` of them, each
    kept if the window reaches it. Every run reaches unit 0: a traced run
    traces it first, and the window always runs it. So every run keeps an
    answer, however soon its seconds are spent. The seed draws the inputs,
    not the units. A stride prime to the input pool's period makes the kept
    units cover distinct inputs; ``stride`` times ``count`` over the pool's
    period spreads them past the pool's first wrap."""

    def __init__(self, stride: int, count: int):
        self.stride = stride
        self.last = stride * (count - 1)  # the last unit kept

    def keeps(self, unit: int) -> bool:
        return unit % self.stride == 0 and unit <= self.last


def mismatch_share(a: torch.Tensor, b: torch.Tensor, tol: float) -> torch.Tensor:
    """Per leading index, the share of entries where ``a`` and ``b`` differ:
    not both NaN, and not both finite within ``tol``."""
    both_nan = torch.isnan(a) & torch.isnan(b)
    close = (a - b).abs() <= tol  # False where either is NaN
    bad = ~(both_nan | close)
    return bad.reshape(bad.shape[0], -1).float().mean(dim=1)


class Clock:
    """The latency of a call that ends synchronised: CUDA events on the
    card (from when the call's first work was enqueued on an idle stream to
    its end), the host's clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop_ms(self, start) -> float:
        """Synchronise and return the milliseconds since ``start``."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)
        return (time.perf_counter() - start) * 1e3
