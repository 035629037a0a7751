"""The program's own spans in a traced run: what
``kangaroo_tpu_torch.utils.profiling`` recorded while the profiler
recorded the traced units, for the readers of the per-layer metrics of the
program's layers (``entry``, ``stage``, ``dispatch``, ``kernel``).

A program without the recorder, or a run without a trace, gives nothing to
read: ``spans`` returns None and the reader says nothing.
"""
from __future__ import annotations


def spans(run) -> list | None:
    """The finished spans of the traced units, or None."""
    t = run.trace
    if t is None or not t.frames:
        return None
    from kangaroo_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return (read() or None) if read is not None else None


def outermost(spans: list, layer: str) -> list:
    """The spans of ``layer`` that no other span of ``layer`` encloses."""
    by_id = {s.id: s for s in spans}

    def enclosed(s) -> bool:
        p = by_id.get(s.parent)
        while p is not None:
            if p.layer == layer:
                return True
            p = by_id.get(p.parent)
        return False

    return [s for s in spans if s.layer == layer and not enclosed(s)]
