"""Traffic for the serving engine, the counterpart of
``repro/serving/workload.py``: numpy only, so a seed gives the same trace
as the reference.

* ``WorkloadSpec`` + ``poisson_trace`` — Poisson arrivals at a target rate
  (0: every request at t = 0) with fixed, uniform or lognormal prompt and
  output lengths, fully determined by the seed.
* ``replay_trace`` — an explicit ``(time_s, prompt_len, max_new_tokens)``
  schedule, for reproducible A/B runs and tests.
* ``interference_trace`` — short requests that decode for long, then one
  long prompt whose whole-prompt admission would stall them.
* ``shared_prefix_trace`` — every prompt is one of a few fixed system
  prompts plus a fresh suffix: the traffic block-level prefix caching
  serves.
* ``bursty_trace`` — waves of same-instant arrivals that overcommit a
  pool sized for the load: the traffic preemption with recompute serves.
* ``lookup_friendly_trace`` — every prompt is one random motif tiled: the
  traffic prompt-lookup speculative decoding serves.
* ``estimate_concurrency`` — the in-flight request count a trace implies,
  for ``cache.suggest_num_blocks`` (``--kv-num-blocks auto``).
* ``OpenLoopDriver`` — replays a trace against the wall clock: submits
  every request whose time has come, then steps the engine; sleeps only
  while the engine is idle and the next arrival is ahead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Sequence, Tuple

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



def replay_trace(
    schedule: Sequence[Tuple[float, int, int]],
    vocab_size: int,
    *,
    seed: int = 0,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_token: int = -1,
) -> List[Arrival]:
    """Deterministic replay of (time_s, prompt_len, max_new_tokens) rows."""
    rng = np.random.default_rng(seed)
    out = []
    for t, plen, max_new in schedule:
        prompt = rng.integers(0, vocab_size, int(plen)).astype(np.int32)
        out.append(Arrival(
            time_s=float(t), prompt=prompt,
            params=SamplingParams(temperature=temperature, top_k=top_k, eos_token=eos_token,
                                  max_new_tokens=int(max_new))))
    return out


def interference_trace(
    vocab_size: int,
    *,
    n_victims: int = 3,
    victim_plen: int = 8,
    victim_new: int = 256,
    long_plen: int = 448,
    long_new: int = 4,
    t_long: float = 0.0,
    seed: int = 0,
    temperature: float = 0.0,
) -> List[Arrival]:
    """``n_victims`` short requests at t = 0 that decode for long, then one
    long-prompt request at ``t_long``: without chunked prefill its
    admission stalls the victims' decodes (their inter-token gap while it
    admits is the measure)."""
    rng = np.random.default_rng(seed)
    arrivals = [
        Arrival(time_s=0.0,
                prompt=rng.integers(0, vocab_size, victim_plen).astype(np.int32),
                params=SamplingParams(temperature=temperature, max_new_tokens=victim_new))
        for _ in range(n_victims)]
    arrivals.append(Arrival(
        time_s=float(t_long),
        prompt=rng.integers(0, vocab_size, long_plen).astype(np.int32),
        params=SamplingParams(temperature=temperature, max_new_tokens=long_new)))
    return arrivals


def shared_prefix_trace(
    vocab_size: int,
    *,
    num_requests: int = 8,
    shared_prefix_len: int = 64,
    num_prefixes: int = 2,
    suffix_len: int = 16,
    max_new: int = 8,
    arrival_rate: float = 0.0,
    seed: int = 0,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_token: int = -1,
) -> List[Arrival]:
    """Each request draws one of ``num_prefixes`` fixed prefixes of
    ``shared_prefix_len`` tokens (the system prompt) and appends a fresh
    ``suffix_len``-token suffix.  Left padding aligns blocks only between
    prompts of one padded length, so the suffix length is fixed.  Poisson
    arrivals at ``arrival_rate`` (0: all at t = 0); same arguments, same
    trace."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab_size, shared_prefix_len).astype(np.int32)
                for _ in range(num_prefixes)]
    arrivals: List[Arrival] = []
    t = 0.0
    for _ in range(num_requests):
        if arrival_rate > 0:
            t += float(rng.exponential(1.0 / arrival_rate))
        k = int(rng.integers(0, num_prefixes))
        suffix = rng.integers(0, vocab_size, suffix_len).astype(np.int32)
        arrivals.append(Arrival(
            time_s=t, prompt=np.concatenate([prefixes[k], suffix]),
            params=SamplingParams(temperature=temperature, top_k=top_k, eos_token=eos_token,
                                  max_new_tokens=max_new)))
    return arrivals



def bursty_trace(
    vocab_size: int,
    *,
    bursts: int = 2,
    burst_size: int = 4,
    gap_s: float = 0.25,
    prompt_len: int = 48,
    max_new: int = 32,
    seed: int = 0,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_token: int = -1,
) -> List[Arrival]:
    """``bursts`` waves of ``burst_size`` same-instant arrivals, ``gap_s``
    apart.  Each wave wants more blocks than a pool sized for the load
    holds: without preemption the wave waits behind FCFS admission, with
    ``preemption="recompute"`` it admits and the newest requests are
    preempted and recomputed as blocks free up.  Same arguments, same
    trace."""
    rng = np.random.default_rng(seed)
    arrivals: List[Arrival] = []
    for b in range(bursts):
        for _ in range(burst_size):
            prompt = rng.integers(0, vocab_size, prompt_len).astype(np.int32)
            arrivals.append(Arrival(
                time_s=b * gap_s, prompt=prompt,
                params=SamplingParams(temperature=temperature, top_k=top_k, eos_token=eos_token,
                                      max_new_tokens=max_new)))
    return arrivals


def lookup_friendly_trace(
    vocab_size: int,
    *,
    num_requests: int = 8,
    motif_len: int = 8,
    repeats: int = 4,
    max_new: int = 32,
    arrival_rate: float = 0.0,
    seed: int = 0,
    temperature: float = 0.0,
    top_k: int = 0,
    eos_token: int = -1,
) -> List[Arrival]:
    """Each prompt is one random ``motif_len``-token motif tiled ``repeats``
    times.  Greedy decoding of such a prompt tends to keep cycling the
    motif, so every generated token's trailing n-gram occurs earlier in
    the stream: what ``speculative="lookup"`` drafts from.  Poisson
    arrivals at ``arrival_rate`` (0: all at t = 0); same arguments, same
    trace."""
    rng = np.random.default_rng(seed)
    arrivals: List[Arrival] = []
    t = 0.0
    for _ in range(num_requests):
        if arrival_rate > 0:
            t += float(rng.exponential(1.0 / arrival_rate))
        motif = rng.integers(0, vocab_size, motif_len).astype(np.int32)
        arrivals.append(Arrival(
            time_s=t, prompt=np.tile(motif, repeats),
            params=SamplingParams(temperature=temperature, top_k=top_k, eos_token=eos_token,
                                  max_new_tokens=max_new)))
    return arrivals


def estimate_concurrency(arrivals: Sequence[Arrival], max_batch: int,
                         q: float = 95.0) -> int:
    """The ``q``-th percentile of the in-flight request count a trace
    implies.  Service times are unknown before the run, so the engine is
    assumed to sustain exactly the offered token load: request i holds a
    slot for tokens_i / R seconds, R = total tokens / the trace's span.
    The count is sampled at every arrival and capped at ``max_batch``; a
    trace with every arrival at one instant saturates the slots."""
    if not arrivals:
        return 1
    t = np.asarray([a.time_s for a in arrivals], np.float64)
    tokens = np.asarray([len(a.prompt) + a.params.max_new_tokens for a in arrivals],
                        np.float64)
    span = float(t.max() - t.min())
    if span <= 0.0:
        return max_batch
    end = t + tokens / (tokens.sum() / span)
    counts = sorted(min(int(np.sum((t <= now) & (now < end))), max_batch) for now in t)
    k = max(int(-(-len(counts) * q // 100)), 1) - 1
    return max(counts[min(k, len(counts) - 1)], 1)



class OpenLoopDriver:
    """Replay a trace against the wall clock while stepping the engine.
    ``t0`` is the ``time.perf_counter`` stamp the trace's times count
    from, set when ``run`` starts."""

    def __init__(self, engine, arrivals: Iterable[Arrival],
                 *, time_scale: float = 1.0, max_steps: int = 100_000):
        self.engine = engine
        self.arrivals = sorted(arrivals, key=lambda a: a.time_s)
        self.time_scale = time_scale     # > 1 compresses the trace
        self.max_steps = max_steps
        self.t0 = 0.0

    def run(self) -> List:
        eng = self.engine
        self.t0 = t0 = time.perf_counter()
        i, steps = 0, 0
        n = len(self.arrivals)
        while (i < n or eng.busy) and steps < self.max_steps:
            now = (time.perf_counter() - t0) * self.time_scale
            while i < n and self.arrivals[i].time_s <= now:
                a = self.arrivals[i]
                eng.submit(a.prompt, a.params)
                i += 1
            if eng.busy:
                eng.step()
                steps += 1
            elif i < n:
                wait = (self.arrivals[i].time_s - now) / self.time_scale
                time.sleep(min(max(wait, 0.0), 0.05))
        eng.flush()
        return eng.finished
