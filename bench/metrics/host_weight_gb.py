"""Weight bytes the engine's placement holds in pinned host memory
(``host_weight_bytes``), the mean over the window's steps, in GB."""


def read(run):
    b = [r.host_weight_bytes for r in run.window_steps]
    return sum(b) / len(b) / 1e9 if b else None
