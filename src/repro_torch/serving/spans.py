"""Wall-clock spans of the serving engine, recorded beside the modeled
telemetry (``serving.telemetry``).

``SpanRecorder`` is the engine's ``TraceRecorder`` (``engine.trace``) with
a list of ``WallSpan``s on the host's wall clock
(``time.perf_counter_ns``) beside its modeled records. The engine opens a
span around each phase of a step (scheduling, each prefill and its device
call, the KV copies, the decode replay, logits to the host, sampling, the
records), around a placement and an interval switch, and one per request
from ``submit`` to its admission (``ServingEngine``'s docstring names
them). ``spans_on`` is the one switch, off by default: with it off, a span
site tests it and does nothing else, so the modeled records, ``to_dict``
and the audit are the same either way.

The spans stay in memory until ``take_wall_spans`` hands them over;
``to_perfetto`` adds them, when any were recorded, as a second process
beside the modeled clock's.

``serving/telemetry.py`` is a verbatim copy of the reference's module, so
the spans extend it here.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter_ns
from typing import Any

from repro_torch.serving.telemetry import TraceRecorder


@dataclasses.dataclass
class WallSpan:
    """One span on the host's wall clock, in ``time.perf_counter_ns``
    nanoseconds. ``parent`` is the index (in the recorder's span list) of
    the span open around it when it opened, -1 for none. A span with a
    ``rid`` and no parent is a request's own span (``request.queued``):
    it lives across steps and encloses none."""
    name: str
    start_ns: int
    end_ns: int = -1               # -1 while open
    parent: int = -1
    rid: int = -1
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def is_request(self) -> bool:
        return self.parent < 0 and self.rid >= 0


class SpanRecorder(TraceRecorder):
    """``TraceRecorder`` with wall-clock spans, recorded while
    ``spans_on``; each span site tests the switch before it calls ``open``
    / ``close``."""

    def __init__(self, name: str, max_batch: int, page_bytes: int):
        super().__init__(name, max_batch, page_bytes)
        self.spans_on = False
        self.wall_spans: list[WallSpan] = []
        self._open: list[tuple[int, WallSpan]] = []   # nested, innermost last

    def open(self, name: str, rid: int = -1, **attrs: Any) -> WallSpan:
        """Open a span inside the innermost open one and return it."""
        span = WallSpan(name, perf_counter_ns(),
                        parent=self._open[-1][0] if self._open else -1,
                        rid=rid, attrs=attrs)
        self._open.append((len(self.wall_spans), span))
        self.wall_spans.append(span)
        return span

    def open_request(self, name: str, rid: int, **attrs: Any) -> WallSpan:
        """Open request ``rid``'s own span: no parent, and never the parent
        of a span opened while it is open."""
        span = WallSpan(name, perf_counter_ns(), rid=rid, attrs=attrs)
        self.wall_spans.append(span)
        return span

    def close(self, span: WallSpan, **attrs: Any) -> None:
        """Close ``span`` and add ``attrs`` to it. Spans opened inside it
        and left open (an exception passed through them) stay open and
        stop enclosing later ones."""
        span.end_ns = perf_counter_ns()
        span.attrs.update(attrs)
        for i in range(len(self._open) - 1, -1, -1):
            if self._open[i][1] is span:
                del self._open[i:]
                break

    def take_wall_spans(self) -> list[WallSpan]:
        """The spans recorded so far, in the order they opened; the list
        starts anew. ``parent`` indexes the list handed over, so take it
        between steps."""
        spans, self.wall_spans, self._open = self.wall_spans, [], []
        return spans

    def to_perfetto(self) -> dict:
        """``TraceRecorder.to_perfetto``, and the closed wall spans as a
        second process (``engine:<name> (wall clock)``), microseconds from
        the first one: the engine's nested spans on one thread, each
        request's own span as an async slice keyed by its rid."""
        out = super().to_perfetto()
        spans = [s for s in self.wall_spans if s.end_ns >= 0]
        if not spans:
            return out
        pid = 1 + max(e["pid"] for e in out["traceEvents"])
        t0 = min(s.start_ns for s in spans)
        us = lambda ns: (ns - t0) / 1e3
        ev = out["traceEvents"]
        ev += [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": f"engine:{self.name} (wall clock)"}},
               {"ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
                "args": {"name": "engine"}}]
        for s in spans:
            args = dict(s.attrs, rid=s.rid) if s.rid >= 0 else s.attrs
            if s.is_request:
                ev += [{"ph": ph, "pid": pid, "tid": 0, "cat": "request",
                        "id": s.rid, "name": s.name, "ts": us(ts),
                        "args": args}
                       for ph, ts in (("b", s.start_ns), ("e", s.end_ns))]
            else:
                ev.append({"ph": "X", "pid": pid, "tid": 0, "name": s.name,
                           "ts": us(s.start_ns),
                           "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": args})
        return out
