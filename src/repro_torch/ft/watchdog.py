"""Straggler / anomaly watchdog.

Tracks per-step (or per-iteration) wall times with an EWMA + deviation bound.
A straggling host shows up as a step-time spike; the mitigation hook ties
into the Select-N knob: raising the offloading interval sheds host-link work
from the straggler (beyond-paper use of the paper's own mechanism), and the
coordinator redistributes the freed bandwidth.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class WatchdogConfig:
    alpha: float = 0.1           # EWMA smoothing
    warmup_steps: int = 5
    slow_factor: float = 1.5     # step considered straggling beyond this
    hard_timeout_s: float | None = None


class StepWatchdog:
    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(),
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.ewma: float | None = None
        self.steps = 0
        self.events: list[dict] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self.observe(dt)
        return dt

    def observe(self, dt: float) -> bool:
        """Feed one step duration; returns True if flagged as straggling."""
        self.steps += 1
        flagged = False
        if self.ewma is None:
            self.ewma = dt
        else:
            if (self.steps > self.cfg.warmup_steps
                    and dt > self.cfg.slow_factor * self.ewma):
                flagged = True
                self.events.append({"step": self.steps, "dt": dt,
                                    "ewma": self.ewma})
                if self.on_straggler:
                    self.on_straggler(self.steps, dt, self.ewma)
            # straggler samples pollute the mean less
            a = self.cfg.alpha * (0.25 if flagged else 1.0)
            self.ewma = (1 - a) * self.ewma + a * dt
        if (self.cfg.hard_timeout_s is not None
                and dt > self.cfg.hard_timeout_s):
            raise TimeoutError(
                f"step {self.steps} took {dt:.2f}s "
                f"(> {self.cfg.hard_timeout_s}s hard timeout)")
        return flagged
