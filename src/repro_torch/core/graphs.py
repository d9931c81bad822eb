"""CUDA-graph capture: the port's counterpart of ``jax.jit``.

The reference compiles the engine's decode step into one executable per
interval (``jax.jit(rt.paged_decode_step)``, ``src/repro/serving/
engine.py:406``) and the analyzer's timed units into one each
(``jax.jit(unit_fn)``, ``src/repro/core/analyzer.py:115,127``), so a call
is one launch whatever the operations inside it. Eager PyTorch issues every
operation from Python, about 70 launches per layer, and the card waits on
the host. ``Graphed`` records a function once into a ``torch.cuda.CUDAGraph``
and each ``replay`` launches all of it at once, so the call's time is the
card's.

A graph reads and writes fixed addresses: callers copy new values into the
tensors of ``Graphed.inputs`` before ``replay`` and read ``Graphed.outputs``
after it, which the next replay overwrites. Work that varies from call to
call in shape or in which host buffers it touches stays outside the graph.

The kernel wrappers count their launches in Python, and a replay runs no
Python: the counts a capture adds are taken back and added again on every
replay, so each counter reads what the same number of eager calls gives.
Callers name further counters of the same kind (``WeightStream.copies``).

Work that cannot sit in the graph but must follow each replay, such as
the weight ring's priming copies, which start on the host after the replay
is launched so that they run beside its tail, is asked for by the captured
function (``around_replay``) and runs around every ``replay``.

The graph is uploaded to the card at capture (``cuGraphUpload``): the
first launch of a graph that was not uploaded does that work itself,
0.7-1.5 ms over the later replays of qwen2.5-3b's 36-layer decode step on
an H100 (ROADMAP Queue C 6), which the engine's clock would count.
Uploading moves no value and runs nothing, so every replay computes what
it computed before.

Used on a GPU only; on the CPU the callers run their functions eagerly.
"""
from __future__ import annotations

import ctypes
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.kernels import prefill_attention

# (object, attribute) of every counter a replay advances
KERNEL_COUNTERS = ((decode_attention, "launches"),
                   (flash_attention, "launches"),
                   (flash_attention, "launches_bwd"),
                   (prefill_attention, "launches"))


# the host work the function being captured asks for around each replay
# (``around_replay``), by the id of the object that asked; None while no
# ``Graphed`` captures
_replay_hooks: dict[int, tuple[Callable, Callable]] | None = None


def around_replay(owner: Any, before: Callable[[], None],
                  after: Callable[[], None]) -> None:
    """Run ``before()`` on the host just before, and ``after()`` just
    after, every replay of the graph that ``Graphed`` is capturing now: one
    pair per ``owner`` and graph. Raises outside a ``Graphed`` capture,
    whose replays would not run them."""
    if _replay_hooks is None:
        raise RuntimeError("host work around each replay needs a graph "
                           "captured by graphs.Graphed")
    if id(owner) in _replay_hooks:
        raise RuntimeError("one pair of replay hooks per owner and graph")
    _replay_hooks[id(owner)] = (before, after)


def upload_graph(graph: torch.cuda.CUDAGraph) -> float:
    """Upload an instantiated graph to the card on the current stream
    (``cuGraphUpload`` from ``libcuda``) and wait for it; returns the host
    seconds it took."""
    stream = torch.cuda.current_stream()
    t0 = time.perf_counter()
    err = ctypes.CDLL("libcuda.so.1").cuGraphUpload(
        ctypes.c_void_p(graph.raw_cuda_graph_exec()),
        ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"cuGraphUpload: CUDA error {err}")
    stream.synchronize()
    return time.perf_counter() - t0


class Graphed:
    """``fn(*inputs)`` captured into one CUDA graph.

    One eager warm-up call on a side stream comes first: it builds the
    kernel libraries (``nvcc``), sets their launch attributes and creates
    cuBLAS's workspace, none of which may happen for the first time inside
    a capture. The warm-up really runs, so ``fn`` must be safe to call twice
    on the same inputs. A capture that fails raises; nothing falls back to
    the eager call. The graph is then uploaded (``upload_s``)."""

    def __init__(self, fn: Callable, inputs: Sequence[Any],
                 counters: Sequence[tuple[Any, str]] = ()):
        self.inputs = tuple(inputs)
        self._counters = list(KERNEL_COUNTERS) + list(counters)
        start = self._read()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        warm = self._read()
        self.graph = torch.cuda.CUDAGraph()
        global _replay_hooks
        _replay_hooks = {}
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)
        finally:
            self._hooks = list(_replay_hooks.values())
            _replay_hooks = None
        self._per_replay = [a - b for a, b in zip(self._read(), warm)]
        self._write(start)
        # (a PyTorch that does not expose the executable graph, or a
        # stand-in graph, uploads nothing: upload_s stays None)
        self.upload_s = (upload_graph(self.graph) if hasattr(
            self.graph, "raw_cuda_graph_exec") else None)

    def _read(self) -> list[int]:
        return [getattr(obj, name) for obj, name in self._counters]

    def _write(self, values: list[int]) -> None:
        for (obj, name), v in zip(self._counters, values):
            setattr(obj, name, v)

    def replay(self) -> Any:
        """Launch the graph on the current stream, with the host work its
        function asked for around it (``around_replay``); returns
        ``outputs``."""
        for before, _ in self._hooks:
            before()
        self.graph.replay()
        self._write([v + d for v, d in zip(self._read(), self._per_replay)])
        for _, after in self._hooks:
            after()
        return self.outputs
