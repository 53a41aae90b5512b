"""The ELANA API of the port: one object per model, the paper's measured
metrics behind it.  The counterpart of ``repro/core/profiler.py``.

    from repro_torch.core.profiler import Elana
    e = Elana("llama3.1-8b")                      # on the GPU
    e.size_report()                               # §2.2 model size
    e.cache_report(batch=128, seq_len=2048)       # §2.2 KV cache
    e.measure(batch=1, prompt_len=512, gen_len=32)  # §2.3/2.4 measured mode
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import cache as cache_prof
from repro_torch.core import energy as energy_lib
from repro_torch.core import latency as lat_lib
from repro_torch.core import size as size_prof
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
        """Measured TTFT/TPOT/TTLT (+ energy when a PowerReader is given)."""
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
            mon = energy_lib.PowerMonitor(power_reader)
            with mon:
                ttft = lp.ttft(batch, prompt_len, iters=iters)
            e = mon.result()
            out.update(ttft_ms=ttft.mean_ms,
                       j_per_prompt=e.joules / (iters * batch))
            with mon:
                tpot = lp.tpot(batch, prompt_len, gen_len=max(gen_len, 4))
            e = mon.result()
            out.update(tpot_ms=tpot.mean_ms,
                       j_per_token=e.joules / (max(gen_len, 4)))
            with mon:
                ttlt = lp.ttlt(batch, prompt_len, gen_len, iters=2)
            e = mon.result()
            out.update(ttlt_ms=ttlt.mean_ms, j_per_request=e.joules / 2)
        return out
