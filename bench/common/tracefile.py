"""Reduction of a ``torch.profiler`` Chrome trace to device busy time,
kernel time by name, copy bytes and idle gaps.

``union_us`` is a frozen copy of ``_union_us`` and ``summary`` follows
``trace_summary``, both of ``src/repro_torch/launch/profile_engine.py``
(lines 750-803): kernels and copies are taken as unions of their spans, so
overlapping work counts once.
"""
from __future__ import annotations

from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clipped_union_us(spans: list[tuple[float, float]],
                     windows: list[tuple[float, float]]) -> float:
    """Length of the union of ``spans`` inside the union of ``windows``."""
    busy, win = merged(spans), merged(windows)
    total, i = 0.0, 0
    for ws, we in win:
        while i < len(busy) and busy[i][1] <= ws:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < we:
            total += min(busy[j][1], we) - max(busy[j][0], ws)
            j += 1
    return total


class Trace:
    """The device and host events of one exported trace, with the host
    spans the harness kept (``host_spans``: perf_counter seconds, mapped
    onto the trace's clock by ``epoch_offset``, see ``add_host``)."""

    def __init__(self, trace: dict, host_spans=(), epoch_offset: float = 0.0):
        self.kernels: list[tuple[float, float]] = []
        self.copies: list[tuple[float, float]] = []
        self.kernel_by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
        self.h2d: list[tuple[float, float, float]] = []   # (s, e, bytes)
        self.host: list[tuple[float, float, str]] = []    # cpu ops, spans
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            name = ev.get("name", "")
            if cat == "kernel":
                self.kernels.append((s, e))
                self.kernel_by_name[name][0] += e - s
                self.kernel_by_name[name][1] += 1
            elif cat in ("gpu_memcpy", "gpu_memset"):
                self.copies.append((s, e))
                if cat == "gpu_memcpy" and "HtoD" in name:
                    nbytes = (ev.get("args") or {}).get("bytes")
                    if nbytes is not None:
                        self.h2d.append((s, e, float(nbytes)))
            elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                         "cuda_driver"):
                self.host.append((s, e, name))
        self.base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3
        self.host_cover = None
        if host_spans:
            self.add_host(host_spans, epoch_offset)

    def add_host(self, spans, epoch_offset: float) -> None:
        """Add host spans timed by ``time.perf_counter`` (seconds). The
        trace's clock is microseconds since the epoch less its
        ``baseTimeNanoseconds``; ``epoch_offset`` is ``time.time() -
        time.perf_counter()``. Where the trace's times are not shifted by
        its base, the shift that puts more of the device's work inside the
        ``bench.step`` spans is taken. ``host_cover`` is the share of the
        device's busy time inside those spans."""
        busy = self.busy_us()
        best = None
        for base in {self.base_us, 0.0}:
            shift = epoch_offset * 1e6 - base
            mapped = [(s * 1e6 + shift, e * 1e6 + shift, n)
                      for s, e, n in spans]
            steps = [(s, e) for s, e, n in mapped if n == "bench.step"]
            cover = self.busy_us(steps) / busy if busy else 0.0
            if best is None or cover > best[0]:
                best = (cover, mapped)
        self.host_cover = best[0]
        self.host.extend(best[1])

    def busy_us(self, windows=None) -> float:
        spans = self.kernels + self.copies
        return (union_us(spans) if windows is None
                else clipped_union_us(spans, windows))

    def annotations(self, name: str) -> list[tuple[float, float]]:
        return [(s, e) for s, e, n in self.host if n == name]

    def kernel_us(self, names: tuple[str, ...]) -> float:
        """Summed time of the kernels whose name contains one of
        ``names``."""
        return sum(t for n, (t, _) in self.kernel_by_name.items()
                   if any(k in n for k in names))

    def top_kernels(self, k: int = 10) -> list[list]:
        ranked = sorted(self.kernel_by_name.items(), key=lambda kv: -kv[1][0])
        return [[n[:120], t / 1e6] for n, (t, _) in ranked[:k]]

    def idle_gaps(self, window: tuple[float, float], k: int = 10
                  ) -> list[list]:
        """The device's idle gaps inside ``window``, summed by the
        innermost host span (a benchmark annotation or a host op) that
        covers each gap's midpoint; the ``k`` largest sums, in seconds."""
        busy = merged([(max(s, window[0]), min(e, window[1]))
                       for s, e in self.kernels + self.copies
                       if e > window[0] and s < window[1]])
        gaps, t = [], window[0]
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < window[1]:
            gaps.append((t, window[1]))
        host = sorted(h for h in self.host if h[1] > h[0])
        by: dict[str, float] = defaultdict(float)
        active: list[tuple[float, float, str]] = []
        i = 0
        for gs, ge in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (gs + ge) / 2
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            inner = min(active, key=lambda h: h[1] - h[0], default=None)
            by[inner[2][:120] if inner else "host: no span"] += (ge - gs) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:k]]
