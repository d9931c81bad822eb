"""How long the compute stream waited for the weight ring in a decode step:
per window step, the summed stall of the ``decode.replay`` span's groups
(``max(0, copy_end - reach)``, CUDA events in the captured graph), the mean
over the decode steps, in ms (core/memory_manager ``WeightStream``)."""
from bench.common import spans


def read(run):
    per_step = [sum(sum(s.attrs["ring_stall_ms"]) for s in calls)
                for calls in spans.ring_walks(run, ("decode.replay",))
                if all("ring_stall_ms" in s.attrs for s in calls)]
    return sum(per_step) / len(per_step) if per_step else None
