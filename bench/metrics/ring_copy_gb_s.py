"""The weight ring's copy rate in the window's decode steps: the bytes of
their ``decode.replay`` walks over the summed time of each unit copy
(``copy_end - copy_start``, CUDA events in the captured graph), in GB/s
(core/memory_manager ``WeightStream``)."""
from bench.common import spans


def read(run):
    calls = [s for c in spans.ring_walks(run, ("decode.replay",)) for s in c
             if "ring_copy_ms" in s.attrs]
    ms = sum(sum(s.attrs["ring_copy_ms"]) for s in calls)
    if ms <= 0:
        return None
    return sum(s.attrs["ring_bytes"] for s in calls) / ms / 1e6
