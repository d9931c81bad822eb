"""Host time of a step: per window step, the ``engine.step`` span's time
outside its device calls (``decode.replay``, ``prefill.compute``: launch
to sync), the mean, in ms (serving/engine)."""
from bench.common import spans


def read(run):
    host = [spans.ms(step) - sum(spans.ms(s) for s in inside
                                 if s.name in spans.DEVICE_CALLS)
            for step, inside in spans.window_steps(run)]
    return sum(host) / len(host) if host else None
