#!/usr/bin/env python3
"""How quickly NVML's board-power reading follows the GPU's load.

    python3 tools/nvml_lag_probe.py

Reads ``nvmlDeviceGetPowerUsage`` every 5 ms (through the port's
``NvmlReader``) while the card idles for 1 s, runs back-to-back bf16
matrix products for 2 s, and idles again for 2 s.  Prints one JSON line:
how often the reading changes value, the idle and loaded levels, and how
long after the load starts (and stops) the reading crosses 50 % and 90 %
of the way between them.  An energy window shorter than that lag is
integrated over power that belongs partly to the work before it.
"""

import json
import statistics
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main():
    import torch

    from repro_torch.core.energy import NvmlReader

    if not torch.cuda.is_available():
        print("nvml_lag_probe: no CUDA device", file=sys.stderr)
        return 1
    reader = NvmlReader([0])
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append((time.perf_counter(), reader.read_watts()[0]))
            time.sleep(0.005)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        time.sleep(1.0)
        t_on = time.perf_counter()
        while time.perf_counter() - t_on < 2.0:
            for _ in range(8):
                a @ a
            torch.cuda.synchronize()
        t_off = time.perf_counter()
        time.sleep(2.0)
    finally:
        stop.set()
        thread.join(timeout=2.0)
        reader.close()

    changes = [t for (t, w), (_, w0) in zip(samples[1:], samples) if w != w0]
    idle = statistics.median(w for t, w in samples if t < t_on)
    loaded = statistics.median(w for t, w in samples if t_off - 0.5 <= t < t_off)

    def crossing(t_from, frac, rising):
        level = idle + frac * (loaded - idle)
        for t, w in samples:
            if t >= t_from and (w >= level if rising else w <= loaded - frac * (loaded - idle)):
                return (t - t_from) * 1e3
        return None

    gaps = [b - a for a, b in zip(changes, changes[1:])]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "reads": len(samples),
        "read_interval_ms": 5, "value_changes": len(changes),
        "update_interval_ms_median": statistics.median(gaps) * 1e3 if gaps else None,
        "idle_watts": idle, "loaded_watts": loaded,
        "rise_50_ms": crossing(t_on, 0.5, True), "rise_90_ms": crossing(t_on, 0.9, True),
        "fall_50_ms": crossing(t_off, 0.5, False), "fall_90_ms": crossing(t_off, 0.9, False),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
