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

Used on a GPU only; on the CPU the callers run their functions eagerly.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.kernels import prefill_attention

# (object, attribute) of every counter a replay advances
KERNEL_COUNTERS = ((decode_attention, "launches"),
                   (flash_attention, "launches"),
                   (prefill_attention, "launches"))


class Graphed:
    """``fn(*inputs)`` captured into one CUDA graph.

    One eager warm-up call on a side stream comes first: it builds the
    kernel libraries (``nvcc``), sets their launch attributes and creates
    cuBLAS's workspace, none of which may happen for the first time inside
    a capture. The warm-up really runs, so ``fn`` must be safe to call twice
    on the same inputs. A capture that fails raises; nothing falls back to
    the eager call."""

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
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)
        self._per_replay = [a - b for a, b in zip(self._read(), warm)]
        self._write(start)

    def _read(self) -> list[int]:
        return [getattr(obj, name) for obj, name in self._counters]

    def _write(self, values: list[int]) -> None:
        for (obj, name), v in zip(self._counters, values):
            setattr(obj, name, v)

    def replay(self) -> Any:
        """Launch the graph on the current stream; returns ``outputs``."""
        self.graph.replay()
        self._write([v + d for v, d in zip(self._read(), self._per_replay)])
        return self.outputs
