"""Mean decode batch of the window's decode steps (the engine's
``IterationRecord.decode_batch``)."""


def read(run):
    b = [r.decode_batch for r in run.window_steps if r.decode_batch]
    return sum(b) / len(b) if b else None
