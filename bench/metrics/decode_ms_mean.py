"""Mean of the engine's ``decode_ms`` (CUDA events around each decode step)
over the window's steps."""


def read(run):
    ms = [x for r in run.window_steps for x in r.decode_ms]
    return sum(ms) / len(ms) if ms else None
