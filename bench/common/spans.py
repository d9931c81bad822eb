"""The program's own wall-clock spans of a traced run, as the readers see
them: ``served.program_spans``, the engine's ``WallSpan``s
(``repro_torch.serving.spans``) over the whole run, each with ``name``,
``start_ns`` and ``end_ns`` (``time.perf_counter_ns``, the harness's
clock; -1 while open), ``parent`` (an index into the list, -1 for none),
``rid`` and ``attrs``. A program that records none leaves the list empty,
and every reader of it returns None.

``common/serve.py`` does not fill ``program_spans`` yet: it would turn the
engine's spans on in ``build_engine`` (``eng.trace.spans_on = True``) when
the run is traced and return ``eng.trace.take_wall_spans()`` from
``serve``. Until it does, ``BENCHMARK.json`` declares none of these
readers, and each returns None on the harness's ``Served``."""
from __future__ import annotations

# the engine's device calls: the stream work of a prefill or decode walk
DEVICE_CALLS = ("decode.replay", "prefill.compute")


def of(run) -> list:
    return getattr(run.served, "program_spans", [])


def ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def window_steps(run) -> list[tuple[object, list]]:
    """Each closed ``engine.step`` span that ended in the window
    [t0, t1), with every span inside it."""
    spans = of(run)
    root = []
    for i, s in enumerate(spans):
        # a parent opens before its children, so its root is known
        root.append(i if s.parent < 0 else root[s.parent])
    inside: dict[int, list] = {}
    for i, s in enumerate(spans):
        if root[i] != i:
            inside.setdefault(root[i], []).append(s)
    t0, t1 = run.served.t0 * 1e9, run.served.t1 * 1e9
    return [(s, inside.get(i, [])) for i, s in enumerate(spans)
            if s.name == "engine.step" and s.end_ns >= 0
            and t0 <= s.end_ns < t1]


def ring_walks(run, names: tuple[str, ...]) -> list[list]:
    """Per window step, its device calls named in ``names`` that carry the
    weight ring's readings; steps without one are left out."""
    out = []
    for _, inside in window_steps(run):
        calls = [s for s in inside
                 if s.name in names and "ring_bytes" in s.attrs]
        if calls:
            out.append(calls)
    return out
