"""Metric readers: one file per metric, ``bench/metrics/<name>.py``, found
by the metric's name in ``BENCHMARK.json``. A reader is a function
``read(run) -> float | None`` over a ``Run``; a reader that finds nothing
to read returns None, and the metric is left out of the result line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

METRICS_DIR = Path(__file__).resolve().parent.parent / "metrics"


@dataclasses.dataclass
class Run:
    """One served cell as the readers see it."""
    cfg: dict                  # bench/configs/<config>.json
    mix: dict                  # bench/traffic/<mix>.json
    served: object             # common.serve.Served
    trace: object = None       # common.tracefile.Trace of the traced run

    @property
    def model(self) -> dict:
        return self.cfg["model"]

    @property
    def window(self) -> list:
        """The requests due in the window."""
        return [t for t in self.served.tracked if t.in_window]

    @property
    def end(self) -> float:
        """The end of the run's last step."""
        s = self.served
        return s.steps[-1].end if s.steps else s.t1

    @property
    def window_steps(self) -> list:
        """The steps that ended in the window."""
        s = self.served
        return [r for r in s.steps if s.t0 <= r.end < s.t1]

    @property
    def traced_steps(self) -> list:
        """The steps inside the traced part of the window."""
        w = self.served.trace_window
        if self.trace is None or w is None:
            return []
        return [r for r in self.served.steps
                if r.start >= w[0] and r.end <= w[1]]


def cell_entries(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``, and those with no such list."""
    return [e for e in bench[kind] if cell in e.get("workloads", [cell])]


def reader(name: str, directory: Path = METRICS_DIR):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}",
        directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(entries: list[dict], run: Run) -> dict:
    """{name: {"value", "unit"}} of the readers that found something."""
    out = {}
    for e in entries:
        v = reader(e["name"])(run)
        if v is not None:
            out[e["name"]] = {"value": v, "unit": e["unit"]}
    return out
