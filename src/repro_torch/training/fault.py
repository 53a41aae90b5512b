"""Fault-tolerance runtime pieces: preemption handling, straggler watchdog,
and elastic-restart bookkeeping.

At 1000+ node scale the failure model is: (a) planned preemption (SIGTERM
with a grace window), (b) node loss mid-step (detected as a step timeout /
collective error -> whole-job restart from the last durable checkpoint),
(c) persistent stragglers (hardware throttling) that stretch step time.
The pieces here cover the in-process halves of those: catch the signal and
checkpoint before dying; track per-step timing statistics and flag outliers;
record the data-stream position so restarts are sample-exact.

The port's own copy of ``repro/training/fault.py`` (it imports no JAX).
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Dict, List, Optional


class PreemptionHandler:
    """SIGTERM/SIGINT -> set a flag the train loop polls at step boundaries."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._requested = threading.Event()
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        self._requested.set()

    @property
    def preemption_requested(self) -> bool:
        return self._requested.is_set()

    # test hook / cooperative preemption
    def request(self) -> None:
        self._requested.set()


@dataclasses.dataclass
class StepTiming:
    step: int
    seconds: float
    is_straggler: bool
    ewma: float


class StragglerWatchdog:
    """EWMA step-time tracker; flags steps slower than ``threshold``x EWMA.

    On a real pod this feeds the controller that decides to evict/replace a
    slow host; here it logs and counts (and its history is assertable in
    tests).  ``hard_timeout_s`` is the give-up bound for hung collectives.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 hard_timeout_s: float = 3600.0,
                 on_straggler: Optional[Callable[[StepTiming], None]] = None):
        self.alpha = alpha
        self.threshold = threshold
        self.hard_timeout_s = hard_timeout_s
        self.on_straggler = on_straggler
        self.history: List[StepTiming] = []
        self._ewma: Optional[float] = None
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> StepTiming:
        assert self._t0 is not None, "start_step not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if self._ewma is None:
            self._ewma = dt
        is_straggler = dt > self.threshold * self._ewma
        if not is_straggler:  # don't poison the EWMA with outliers
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        timing = StepTiming(step=step, seconds=dt, is_straggler=is_straggler,
                            ewma=self._ewma)
        self.history.append(timing)
        if is_straggler and self.on_straggler:
            self.on_straggler(timing)
        return timing

    @property
    def straggler_count(self) -> int:
        return sum(1 for t in self.history if t.is_straggler)

    @property
    def mean_step_s(self) -> float:
        if not self.history:
            return 0.0
        return sum(t.seconds for t in self.history) / len(self.history)


@dataclasses.dataclass
class RunPosition:
    """Everything needed to resume sample-exact after a restart."""

    step: int
    data_epoch: int
    data_offset: int            # samples consumed within the epoch
    rng_seed: int

    def to_metadata(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_metadata(cls, meta: Dict) -> "RunPosition":
        return cls(step=int(meta.get("step", 0)),
                   data_epoch=int(meta.get("data_epoch", 0)),
                   data_offset=int(meta.get("data_offset", 0)),
                   rng_seed=int(meta.get("rng_seed", 0)))
