"""The ELANA API of the port: one object per model, the paper's measured
metrics behind it.  The counterpart of ``repro/core/profiler.py``.

    from repro_torch.core.profiler import Elana
    e = Elana("llama3.1-8b")                      # on the GPU
    e.size_report()                               # §2.2 model size
    e.cache_report(batch=128, seq_len=2048)       # §2.2 KV cache
    e.measure(batch=1, prompt_len=512, gen_len=32)  # §2.3/2.4 measured mode
    e.estimate(hardware="h100", batch=1)          # §2.3/2.4 estimator mode
    e.trace(path="trace.json")                    # §2.5 Perfetto timeline

Size, cache, estimate and trace work from shapes alone; only ``measure``
draws weights on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import cache as cache_prof
from repro_torch.core import energy as energy_lib
from repro_torch.core import estimator as est_lib
from repro_torch.core import latency as lat_lib
from repro_torch.core import size as size_prof
from repro_torch.core import trace as trace_lib
from repro_torch.models import model as model_lib


class Elana:
    def __init__(self, arch: str, *, smoke: bool = False, device="cuda", seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = get_config(arch, smoke=smoke)
        self._seed = seed
        self._model: Optional[model_lib.Model] = None
        self._lat: Optional[lat_lib.LatencyProfiler] = None

    # -- lazy weights (measured mode only) ------------------------------------
    @property
    def model(self) -> model_lib.Model:
        if self._model is None:
            gen = torch.Generator(device=self.device).manual_seed(self._seed)
            self._model = model_lib.init(self.cfg, gen, self.device)
        return self._model

    def _latency_profiler(self) -> lat_lib.LatencyProfiler:
        if self._lat is None:
            self._lat = lat_lib.LatencyProfiler(self.cfg, self.model,
                                                seed=self._seed, device=self.device)
        return self._lat

    # -- §2.2 sizes ------------------------------------------------------------
    def size_report(self) -> size_prof.SizeReport:
        return size_prof.profile_size(self.cfg)

    def cache_report(self, batch: int, seq_len: int) -> cache_prof.CacheReport:
        return cache_prof.profile_cache(self.cfg, batch, seq_len)

    # -- §2.3/2.4 measured latency and energy ----------------------------------
    def measure(
        self,
        batch: int = 1,
        prompt_len: int = 64,
        gen_len: int = 16,
        iters: int = 5,
        power_reader: Optional[energy_lib.PowerReader] = None,
    ) -> Dict[str, float]:
        """Measured TTFT/TPOT/TTLT (+ energy when a PowerReader is given).
        Each joule figure is the reader's energy over the timed samples only
        (``LatencyStats.window``: warm-up and the graph capture excluded)
        over the prompts, tokens or requests they hold; the reference keeps
        warm-up in its windows and divides by steps and iterations."""
        lp = self._latency_profiler()
        out: Dict[str, float] = {}
        if power_reader is None:
            ttft = lp.ttft(batch, prompt_len, iters=iters)
            tpot = lp.tpot(batch, prompt_len, gen_len=max(gen_len, 4))
            ttlt = lp.ttlt(batch, prompt_len, gen_len, iters=max(2, iters // 2))
            out.update(ttft_ms=ttft.mean_ms, tpot_ms=tpot.mean_ms,
                       ttlt_ms=ttlt.mean_ms,
                       ttft_p95_ms=ttft.p95_s * 1e3, tpot_p95_ms=tpot.p95_s * 1e3)
        else:
            n_tok = max(gen_len, 4)
            mon = energy_lib.PowerMonitor(power_reader)
            with mon:
                ttft = lp.ttft(batch, prompt_len, iters=iters)
            out.update(ttft_ms=ttft.mean_ms,
                       j_per_prompt=mon.joules_between(*ttft.window) / (iters * batch))
            with mon:
                tpot = lp.tpot(batch, prompt_len, gen_len=n_tok)
            out.update(tpot_ms=tpot.mean_ms,
                       j_per_token=mon.joules_between(*tpot.window) / (n_tok * batch))
            with mon:
                ttlt = lp.ttlt(batch, prompt_len, gen_len, iters=2)
            out.update(ttlt_ms=ttlt.mean_ms,
                       j_per_request=mon.joules_between(*ttlt.window) / (2 * batch))
        return out

    # -- §2.3/2.4 estimator mode --------------------------------------------------
    def estimate(
        self,
        hardware: str = "h100",
        n_devices: int = 1,
        mode: str = "tp",
        batch: int = 1,
        prompt_len: int = 512,
        gen_len: int = 512,
    ) -> est_lib.WorkloadEstimate:
        return est_lib.estimate_workload(
            self.cfg, hardware=hardware, n_devices=n_devices, mode=mode,
            batch=batch, prompt_len=prompt_len, gen_len=gen_len,
        )

    # -- §2.5 kernel-level trace ---------------------------------------------------
    def trace(
        self,
        path: str,
        hardware: str = "h100",
        phase: str = "decode",
        batch: int = 1,
        seq_len: int = 1024,
    ) -> Dict[str, float]:
        events = trace_lib.estimated_timeline(
            self.cfg, hardware=hardware, phase=phase, batch=batch, seq_len=seq_len,
        )
        trace_lib.to_chrome_trace(events, path, meta={
            "arch": self.cfg.name, "hardware": hardware, "phase": phase,
            "batch": batch, "seq_len": seq_len,
        })
        return trace_lib.timeline_summary(events)
