"""Bytes the weight ring copied host-to-device per window step, over its
prefill and decode walks (``WeightStream.copy_bytes`` read around each
device call), the mean over every window step, in GB."""
from bench.common import spans


def read(run):
    steps = spans.window_steps(run)
    if not any("ring_bytes" in s.attrs for _, inside in steps
               for s in inside):
        return None
    total = sum(s.attrs.get("ring_bytes", 0) for _, inside in steps
                for s in inside if s.name in spans.DEVICE_CALLS)
    return total / len(steps) / 1e9
