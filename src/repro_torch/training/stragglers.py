"""Straggler detection: per-step wall-time watchdog with EWMA baseline — a
copy of the reference's ``training/stragglers.py`` (host arithmetic only).

On a synchronous SPMD program a single slow host gates every step (the
all-reduce waits). The watchdog keeps an exponentially-weighted baseline of
step time; a step slower than ``threshold x baseline`` raises a flag, and
``k`` consecutive flags fire the mitigation callback (``launch/train.py``
prints a straggler flag).

In a deployment of many hosts each also reports its *pre-barrier* compute
time via an all-gather of one scalar so the slow host is identifiable
(``attribute()``); one process exercises the same logic with injected
timings (``tests/test_torch_train_launch.py`` uses a fake clock).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class WatchdogConfig:
    ewma_alpha: float = 0.1
    threshold: float = 2.0  # step is "slow" above threshold x baseline
    patience: int = 3  # consecutive slow steps before firing
    warmup_steps: int = 5  # compile/first-touch steps excluded from baseline


class StepWatchdog:
    def __init__(
        self,
        config: WatchdogConfig = WatchdogConfig(),
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = config
        self.on_straggler = on_straggler
        self.clock = clock
        self.baseline: Optional[float] = None
        self.step = 0
        self._slow_run = 0
        self._t0: Optional[float] = None
        self.history: List[float] = []
        self.fired = 0

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self) -> float:
        """Record one step; returns its duration. Fires callback on patience."""
        assert self._t0 is not None, "start() not called"
        dt = self.clock() - self._t0
        self._t0 = None
        self.step += 1
        self.history.append(dt)
        if self.step <= self.cfg.warmup_steps:
            return dt
        if self.baseline is None:
            self.baseline = dt
            return dt
        slow = dt > self.cfg.threshold * self.baseline
        if slow:
            self._slow_run += 1
            if self._slow_run >= self.cfg.patience:
                self.fired += 1
                self._slow_run = 0
                if self.on_straggler is not None:
                    self.on_straggler(self.step, dt, self.baseline)
        else:
            self._slow_run = 0
            a = self.cfg.ewma_alpha
            self.baseline = (1 - a) * self.baseline + a * dt
        return dt


def attribute(per_host_compute_s: np.ndarray, threshold: float = 1.5):
    """Which hosts are stragglers, from the all-gathered pre-barrier times.

    Returns (indices, median): hosts slower than threshold x median.
    """
    med = float(np.median(per_host_compute_s))
    idx = np.nonzero(per_host_compute_s > threshold * med)[0]
    return idx.tolist(), med
