"""Seconds the engine spent placing weights over the whole run: its
``engine.place`` spans (the interval's split put on the card and its
offloaded units pinned) and ``engine.set_interval`` spans (a switch: the
old placement released, the KV pool re-accounted), summed
(core/memory_manager)."""
from bench.common import spans


def read(run):
    got = [spans.ms(s) for s in spans.of(run) if s.end_ns >= 0
           and s.name in ("engine.place", "engine.set_interval")]
    return sum(got) / 1e3 if got else None
