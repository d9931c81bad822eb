"""Mean of the engine's ``prefill_ms`` (CUDA events around each one-shot
prefill, host gaps included) over the window's steps."""


def read(run):
    ms = [x for r in run.window_steps for x in r.prefill_ms]
    return sum(ms) / len(ms) if ms else None
