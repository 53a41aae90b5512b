"""Energy profiling (paper §2.4), the counterpart of ``repro/core/energy.py``.

The paper's method: a sampler reads instantaneous power at 10 Hz, the
energy of a latency window is the integral of that power over the window,
and the powers of several devices are summed.  ``PowerMonitor`` runs the
sampler in a background thread around a workload (CUDA work runs with the
interpreter lock released, so the thread keeps its cadence).

* ``NvmlReader``      — NVIDIA GPUs, through ``libnvidia-ml.so.1`` by ctypes.
* ``ProcStatReader``  — the host CPU: /proc/stat busy fraction × a TDP model.
* ``ModelReader``     — a utilization-scaled TDP model, for hardware without
  a power API or for estimator-mode accounting.
* ``SyntheticReader`` — a deterministic waveform, for tests.
"""

from __future__ import annotations

import bisect
import ctypes
import dataclasses
import threading
import time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple


class PowerReader:
    """Interface: instantaneous power in watts, one value per device."""

    def read_watts(self) -> Sequence[float]:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyntheticReader(PowerReader):
    def __init__(self, fn: Callable[[float], float], n_devices: int = 1):
        self._fn = fn
        self._n = n_devices
        self._t0 = time.perf_counter()

    def read_watts(self) -> Sequence[float]:
        w = self._fn(time.perf_counter() - self._t0)
        return [w] * self._n


class ModelReader(PowerReader):
    """Utilization-scaled TDP model: idle + (tdp - idle) * utilization."""

    def __init__(self, idle_watts: float, tdp_watts: float,
                 utilization_fn: Optional[Callable[[], float]] = None,
                 n_devices: int = 1):
        self.idle = idle_watts
        self.tdp = tdp_watts
        self.util_fn = utilization_fn or (lambda: 1.0)
        self._n = n_devices

    def read_watts(self) -> Sequence[float]:
        u = min(max(self.util_fn(), 0.0), 1.0)
        return [self.idle + (self.tdp - self.idle) * u] * self._n


class ProcStatReader(PowerReader):
    """CPU package power proxy from /proc/stat busy fraction × TDP."""

    def __init__(self, idle_watts: float = 10.0, tdp_watts: float = 65.0):
        self.idle = idle_watts
        self.tdp = tdp_watts
        self._last = self._read_stat()

    @staticmethod
    def _read_stat() -> Tuple[float, float]:
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:]
        vals = [float(x) for x in parts[:8]]
        idle = vals[3] + vals[4]
        total = sum(vals)
        return idle, total

    def read_watts(self) -> Sequence[float]:
        idle, total = self._read_stat()
        last_idle, last_total = self._last
        self._last = (idle, total)
        d_total = total - last_total
        busy = 1.0 - (idle - last_idle) / d_total if d_total > 0 else 0.0
        return [self.idle + (self.tdp - self.idle) * busy]


class NvmlReader(PowerReader):
    """Board power of NVIDIA GPUs from NVML (``nvmlDeviceGetPowerUsage``,
    milliwatts), called through ctypes.  Raises if NVML cannot be loaded
    or a read fails; it never reports 0 W in place of a reading."""

    def __init__(self, device_indices: Optional[Sequence[int]] = None):
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as e:
            raise RuntimeError("NVML (libnvidia-ml.so.1) cannot be loaded") from e
        lib.nvmlInit_v2.argtypes = []
        lib.nvmlDeviceGetCount_v2.argtypes = [ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
            ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetPowerUsage.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlShutdown.argtypes = []
        for fn in (lib.nvmlInit_v2, lib.nvmlDeviceGetCount_v2,
                   lib.nvmlDeviceGetHandleByIndex_v2,
                   lib.nvmlDeviceGetPowerUsage, lib.nvmlShutdown):
            fn.restype = ctypes.c_int
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        n = ctypes.c_uint()
        self._check(lib.nvmlDeviceGetCount_v2(ctypes.byref(n)), "nvmlDeviceGetCount_v2")
        idx = list(device_indices) if device_indices is not None else range(n.value)
        self._handles = []
        for i in idx:
            h = ctypes.c_void_p()
            self._check(lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h)),
                        f"nvmlDeviceGetHandleByIndex_v2({i})")
            self._handles.append(h)
        if not self._handles:
            raise RuntimeError("NVML found no GPU to read")

    @staticmethod
    def _check(status: int, what: str) -> None:
        if status != 0:
            raise RuntimeError(f"{what} failed with NVML status {status}")

    def read_watts(self) -> Sequence[float]:
        out = []
        for h in self._handles:
            mw = ctypes.c_uint()
            self._check(self._lib.nvmlDeviceGetPowerUsage(h, ctypes.byref(mw)),
                        "nvmlDeviceGetPowerUsage")
            if mw.value == 0:
                raise RuntimeError("NVML reported 0 W")
            out.append(mw.value / 1000.0)
        return out

    def close(self) -> None:
        self._lib.nvmlShutdown()


@dataclasses.dataclass
class EnergyResult:
    duration_s: float
    avg_watts: float            # summed across devices (paper: multi-GPU sum)
    joules: float
    samples: List[Tuple[float, List[float]]]  # (t, per-device watts)
    n_devices: int
    # achieved sampler rate over the window — the >= 5-10 Hz protocol
    # requirement is verifiable from the result, not assumed
    samples_per_sec: float = 0.0
    # reads that raised or returned empty (each leaves a gap the step
    # function backfills with the previous sample's power)
    dropped_reads: int = 0

    def per(self, count: int) -> float:
        """J/Token, J/Prompt, J/Request — divide by the unit count."""
        return self.joules / max(count, 1)


def integrate_joules(
    samples: Sequence[Tuple[float, Sequence[float]]], t0: float, t1: float
) -> float:
    """Energy over [t0, t1] treating the samples as a step function.

    Power at time t is the (device-summed) watts of the latest sample at or
    before t (the first sample extends backwards).  Because the step
    function is fixed, the integral is *additive* over adjacent windows:
    tiling [t0, t1] with sub-windows and summing reproduces the total
    exactly — the property per-request energy attribution relies on.
    """
    if t1 <= t0 or not samples:
        return 0.0
    ts = [t for t, _ in samples]
    ws = [sum(w) for _, w in samples]
    total = 0.0
    cur = t0
    # index of the sample governing time `cur`
    i = max(bisect.bisect_right(ts, cur) - 1, 0)
    while cur < t1:
        nxt = ts[i + 1] if i + 1 < len(ts) else t1
        seg_end = min(max(nxt, cur), t1)
        total += ws[i] * (seg_end - cur)
        cur = seg_end
        if i + 1 < len(ts) and ts[i + 1] <= cur:
            i += 1
    return total


class PowerMonitor:
    """10 Hz sampler thread; use as a context manager around a workload."""

    def __init__(self, reader: PowerReader, interval_s: float = 0.1):
        self.reader = reader
        self.interval_s = interval_s
        self._samples: List[Tuple[float, List[float]]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self._t1 = 0.0
        self.dropped_reads = 0

    def _loop(self):
        # absolute-deadline scheduling: waiting ``interval_s`` *after* each
        # read lets slow reads (NVML can take ~ms) drift the achieved rate
        # below target; instead each wait targets t0 + k*interval, so read
        # latency eats into the idle wait, not the cadence
        deadline = self._t0 + self.interval_s
        while not self._stop.is_set():
            t = time.perf_counter()
            try:
                watts = list(self.reader.read_watts())
            except Exception:
                watts = []
            if watts:
                self._samples.append((t, watts))
            else:
                # a dropped read leaves a gap the step-function integral
                # backfills with stale power — count it, don't hide it
                self.dropped_reads += 1
            now = time.perf_counter()
            while deadline <= now:  # reads slower than the interval: skip
                deadline += self.interval_s
            self._stop.wait(deadline - now)

    def __enter__(self) -> "PowerMonitor":
        self._samples.clear()
        self.dropped_reads = 0
        self._stop.clear()
        self._t0 = time.perf_counter()
        self._t1 = 0.0
        # one synchronous sample so even sub-interval windows are covered
        try:
            self._samples.append((self._t0, list(self.reader.read_watts())))
        except Exception:
            self.dropped_reads += 1
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._t1 = time.perf_counter()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self.dropped_reads:
            warnings.warn(
                f"PowerMonitor dropped {self.dropped_reads} power reads "
                f"(reader raised or returned empty); the step-function "
                f"integral backfills those gaps with the previous sample",
                RuntimeWarning, stacklevel=2)

    @property
    def window(self) -> Tuple[float, float]:
        """(enter, exit) perf_counter stamps (exit == now while running)."""
        t1 = self._t1 if self._t1 > self._t0 else time.perf_counter()
        return self._t0, t1

    def joules_between(self, t0: float, t1: float) -> float:
        """Step-function energy over [t0, t1] (additive across windows)."""
        return integrate_joules(self._samples, t0, t1)

    def result(self) -> EnergyResult:
        t0, t1 = self.window
        duration = max(t1 - t0, 1e-9)
        window = [(t, w) for t, w in self._samples if t0 <= t <= t1 + 1e-3]
        if not window:
            window = self._samples[-1:] or [(t0, [0.0])]
        n_dev = max(len(w) for _, w in window)
        # one ledger: the run total is the same step-function integral
        # per-request attribution uses (``joules_between``), so tiling the
        # window with per-request sub-windows reproduces it exactly.  An
        # unweighted sample mean times the duration disagrees under
        # sampling jitter — the sub-windows then don't sum to the total.
        joules = integrate_joules(self._samples, t0, t1)
        return EnergyResult(
            duration_s=duration,
            avg_watts=joules / duration,
            joules=joules,
            samples=window,
            n_devices=n_dev,
            samples_per_sec=len(self._samples) / duration,
            dropped_reads=self.dropped_reads,
        )


def measure_energy(
    fn: Callable[[], object], reader: PowerReader, interval_s: float = 0.1
) -> EnergyResult:
    """Run ``fn`` under the sampler, waiting for the GPU's queued work
    before the window closes; energy = the sampled power integrated over
    the window."""
    import torch

    with PowerMonitor(reader, interval_s) as mon:
        fn()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return mon.result()
