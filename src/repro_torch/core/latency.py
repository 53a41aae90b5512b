"""Measured-mode latency profiling: TTFT / TPOT / TTLT (paper §2.3), the
counterpart of ``repro/core/latency.py``.

Semantics follow the paper:

* **TTFT** — latency of the prefill forward pass on a fresh random prompt.
* **TPOT** — inter-token interval of autoregressive decode against a
  prefilled cache.
* **TTLT** — end-to-end prefill + generation for a batch of requests.

Each sample is host ``perf_counter`` time around work that ends in
``torch.cuda.synchronize()``; the device is also synchronized before the
clock starts, so queued set-up work is not counted.  The first calls of
each measurement are warm-up and are reported as ``compile_s``: on the
card they include Triton's JIT, the CUDA kernels' first launches and
cuBLAS's first calls.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Cache, Model


@dataclasses.dataclass
class LatencyStats:
    name: str
    samples_s: List[float]
    compile_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.samples_s)

    @property
    def std_s(self) -> float:
        return statistics.pstdev(self.samples_s) if len(self.samples_s) > 1 else 0.0

    @property
    def p50_s(self) -> float:
        return statistics.median(self.samples_s)

    @property
    def p95_s(self) -> float:
        xs = sorted(self.samples_s)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    def summary(self) -> Dict[str, float]:
        return {
            "name": self.name, "mean_ms": self.mean_ms,
            "std_ms": self.std_s * 1e3, "p50_ms": self.p50_s * 1e3,
            "p95_ms": self.p95_s * 1e3, "n": len(self.samples_s),
            "compile_ms": self.compile_s * 1e3,
        }


class LatencyProfiler:
    """TTFT / TPOT / TTLT measurement for one model + workload."""

    def __init__(self, cfg: ModelConfig, model: Model, *, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, profiler on {self.device}")
        self.cfg = cfg
        self.model = model
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    # -- helpers -------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _random_batch(self, batch: int, prompt_len: int) -> Dict[str, torch.Tensor]:
        return {"tokens": torch.randint(0, self.cfg.vocab_size, (batch, prompt_len),
                                        generator=self.gen, device=self.device)}

    def _fresh_cache(self, batch: int, max_len: int) -> Cache:
        return self.model.init_cache(batch, max_len)

    def _positions(self, batch: int, start: int) -> torch.Tensor:
        """Decode positions kept on the device and advanced there, so the
        decode loop issues no host-to-device copy."""
        return torch.full((batch,), start, dtype=torch.int32, device=self.device)

    @staticmethod
    def _greedy(logits: torch.Tensor) -> torch.Tensor:
        return logits.argmax(dim=-1, keepdim=True)

    # -- metrics ---------------------------------------------------------------
    def ttft(self, batch: int, prompt_len: int, iters: int = 10,
             warmup: int = 2) -> LatencyStats:
        """Prefill latency; fresh random prompt each run (paper §2.3)."""
        cache = self._fresh_cache(batch, prompt_len + 1)
        samples, t_compile = [], 0.0
        for i in range(warmup + iters):
            b = self._random_batch(batch, prompt_len)
            self._sync()
            t0 = time.perf_counter()
            self.model.prefill(b, cache)
            self._sync()
            dt = time.perf_counter() - t0
            if i < warmup:
                t_compile += dt
            else:
                samples.append(dt)
        return LatencyStats(name="ttft", samples_s=samples, compile_s=t_compile)

    def tpot(self, batch: int, prompt_len: int, gen_len: int = 32,
             warmup: int = 2) -> LatencyStats:
        """Per-token decode latency after prefilling a random prompt."""
        cache = self._fresh_cache(batch, prompt_len + gen_len + 1)
        logits, cache = self.model.prefill(self._random_batch(batch, prompt_len), cache)
        tok = self._greedy(logits)
        pos = self._positions(batch, prompt_len)
        # warm-up steps write the same position the first timed step rewrites
        self._sync()
        t0 = time.perf_counter()
        for _ in range(warmup):
            self.model.decode_step(tok, pos, cache)
            self._sync()
        compile_s = time.perf_counter() - t0
        samples = []
        for _ in range(gen_len):
            t0 = time.perf_counter()
            logits, cache = self.model.decode_step(tok, pos, cache)
            self._sync()
            samples.append(time.perf_counter() - t0)
            tok = self._greedy(logits)
            pos += 1
        return LatencyStats(name="tpot", samples_s=samples, compile_s=compile_s)

    def ttlt(self, batch: int, prompt_len: int, gen_len: int,
             iters: int = 3) -> LatencyStats:
        """End-to-end request latency: prefill + gen_len decode steps."""
        max_len = prompt_len + gen_len + 1
        self.ttft(batch, prompt_len, iters=1, warmup=1)
        self.tpot(batch, prompt_len, gen_len=1, warmup=1)
        samples = []
        for _ in range(iters):
            cache = self._fresh_cache(batch, max_len)
            b = self._random_batch(batch, prompt_len)
            pos = self._positions(batch, prompt_len)
            self._sync()
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(b, cache)
            tok = self._greedy(logits)
            for _ in range(gen_len):
                logits, cache = self.model.decode_step(tok, pos, cache)
                tok = self._greedy(logits)
                pos += 1
            self._sync()
            samples.append(time.perf_counter() - t0)
        return LatencyStats(name="ttlt", samples_s=samples)
