"""Traffic for the serving engine, the counterpart of the Poisson part of
``repro/serving/workload.py``: numpy only, so a seed gives the same trace
as the reference.

``WorkloadSpec`` + ``poisson_trace`` — Poisson arrivals at a target rate
(0: every request at t = 0) with fixed, uniform or lognormal prompt and
output lengths, fully determined by the seed.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Token-count distribution: fixed / uniform / lognormal."""

    kind: str = "fixed"          # "fixed" | "uniform" | "lognormal"
    mean: float = 64.0
    low: int = 1                 # uniform lower bound / global clamp
    high: int = 4096             # uniform upper bound (exclusive) / global clamp
    sigma: float = 0.5           # lognormal shape

    def sample(self, rng: np.random.Generator) -> int:
        if self.kind == "fixed":
            n = self.mean
        elif self.kind == "uniform":
            n = rng.integers(self.low, max(self.high, self.low + 1))
        elif self.kind == "lognormal":
            # parameterised so E[n] == mean
            mu = np.log(max(self.mean, 1.0)) - 0.5 * self.sigma ** 2
            n = rng.lognormal(mu, self.sigma)
        else:
            raise ValueError(f"unknown length dist {self.kind!r}")
        return int(np.clip(round(float(n)), self.low, self.high))


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    arrival_rate: float = 4.0            # requests / second (Poisson)
    num_requests: int = 8
    prompt_len: LengthDist = LengthDist(kind="uniform", low=4, high=48)
    output_len: LengthDist = LengthDist(kind="fixed", mean=16)
    temperature: float = 0.8
    top_k: int = 20
    eos_token: int = -1
    seed: int = 0


@dataclasses.dataclass
class Arrival:
    time_s: float                        # offset from trace start
    prompt: np.ndarray                   # (prompt_len,) int32
    params: SamplingParams


def poisson_trace(spec: WorkloadSpec, vocab_size: int) -> List[Arrival]:
    """Sampled arrival schedule; same (spec, vocab_size) -> same trace."""
    rng = np.random.default_rng(spec.seed)
    arrivals: List[Arrival] = []
    t = 0.0
    for _ in range(spec.num_requests):
        if spec.arrival_rate > 0:
            t += float(rng.exponential(1.0 / spec.arrival_rate))
        plen = spec.prompt_len.sample(rng)
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        arrivals.append(Arrival(
            time_s=t, prompt=prompt,
            params=SamplingParams(
                temperature=spec.temperature, top_k=spec.top_k,
                eos_token=spec.eos_token,
                max_new_tokens=spec.output_len.sample(rng))))
    return arrivals
