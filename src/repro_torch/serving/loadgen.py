"""Steady-state load generator for the HTTP serving path, the counterpart
of ``repro/serving/loadgen.py`` on the port's standard-library client.

The protocol (vLLM's benchmark serving flow; TokenPowerBench; The Price of
Prompting):

1. **Warm-up** — drive the server for ``warmup_s`` before measuring, so
   ramp-up never enters the numbers.
2. **Steady-state window** — a fixed ``duration_s`` window; only requests
   *sent* inside it count.  The ``PowerMonitor`` is entered at the
   window's start and exited at its end (``phase_clock``), so its
   ``result()`` is the energy of exactly the measured window.
3. **Drive modes** — closed loop (``concurrency`` workers, each sending
   its next request the moment the previous one ends: the server always
   sees N in flight) or open loop (Poisson arrivals at ``qps`` whatever
   the completions: the queueing delay a closed loop hides shows).
4. **Energy attribution** — the window is tiled with contiguous
   per-request sub-windows whose widths follow the completion token
   counts, and each request's share is ``monitor.joules_between`` over
   its tile.  The step-function integral is additive over adjacent
   windows, so the shares sum to ``monitor.result().joules`` exactly.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.serving.client import ClientRecord, stream_completion


@dataclasses.dataclass
class LoadSpec:
    mode: str = "closed"        # "closed" (concurrency N) | "open" (Poisson)
    concurrency: int = 2        # closed loop: requests in flight
    qps: float = 4.0            # open loop: mean Poisson arrival rate
    warmup_s: float = 1.0       # unmeasured ramp before the window
    duration_s: float = 5.0     # steady-state measurement window
    max_requests: int = 10_000  # safety cap across the whole run
    prompt_len: int = 16
    prompt_pool: int = 8        # distinct prompts cycled through
    max_new: int = 16
    temperature: float = 0.0
    top_k: int = 0
    vocab_size: int = 128
    seed: int = 0


@dataclasses.dataclass
class LoadResult:
    records: List[ClientRecord]          # steady state, without errors
    all_records: List[ClientRecord]      # with warm-up, late ones and errors
    window: Tuple[float, float]          # the steady-state [start, end)
    summary: Dict[str, float]


def prewarm_engine(engine, *, prompt_len: int, concurrency: int, vocab_size: int,
                   max_new: int = 4, seed: int = 0) -> None:
    """Run the work the load will run once before the server starts: an
    eager prefill at the load's prompt bucket (on the GPU: cuBLAS picks its
    algorithms, the caching allocator grows) and decode steps at the load's
    slot occupancy.  The CUDA graphs are captured in the engine's
    constructor already.  Call it before ``start_http_server``: afterwards
    the engine thread owns the engine."""
    from repro_torch.serving.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab_size, prompt_len).astype(np.int32)
               for _ in range(max(concurrency, 1))]
    # staggered admission: each later request lands while the earlier ones
    # decode, so admission beside decoding slots runs too, not only a
    # prefill-only step and decode-only steps
    engine.submit(prompts[0], SamplingParams(max_new_tokens=max_new))
    for p in prompts[1:]:
        engine.step()
        engine.submit(p, SamplingParams(max_new_tokens=max_new))
    engine.run()


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile on (len - 1) * q, rounded, as the
    reference's load generator takes it; 0.0 for an empty list."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    idx = min(int(round(q / 100.0 * (len(xs) - 1))), len(xs) - 1)
    return xs[idx]


def attribute_energy(records: List[ClientRecord], monitor) -> float:
    """Tile ``monitor.window`` with per-request sub-windows proportional to
    completion token counts (in first-chunk order); each request's
    ``joules`` is ``joules_between`` over its tile.  The integral is
    additive, so the shares sum to ``monitor.result().joules`` exactly."""
    t0, t1 = monitor.window
    ordered = sorted(records, key=lambda r: r.first_chunk_time)
    toks = [len(r.tokens) for r in ordered]
    total = sum(toks)
    if total == 0 or t1 <= t0:
        return 0.0
    attributed = 0.0
    cur = t0
    acc = 0
    for i, (rec, n) in enumerate(zip(ordered, toks)):
        acc += n
        # the last edge lands exactly on t1, so the tiles cover the window
        # with shared edges: the condition for exactness
        nxt = t1 if i == len(ordered) - 1 else t0 + (t1 - t0) * (acc / total)
        rec.joules = monitor.joules_between(cur, nxt)
        attributed += rec.joules
        cur = nxt
    return attributed


def summarize(records: List[ClientRecord], window: Tuple[float, float],
              monitor=None) -> Dict[str, float]:
    ws, we = window
    dur = max(we - ws, 1e-9)
    total_tokens = sum(len(r.tokens) for r in records)
    ttft = [r.client_ttft_s * 1e3 for r in records if r.tokens]
    tpot = [r.client_tpot_s * 1e3 for r in records if len(r.tokens) >= 2]
    ttlt = [r.client_ttlt_s * 1e3 for r in records if r.tokens]
    summary: Dict[str, float] = {
        "steady_requests": float(len(records)),
        "steady_window_s": dur,
        "achieved_qps": len(records) / dur,
        "client_tokens_per_sec": total_tokens / dur,
    }
    for name, xs in (("ttft", ttft), ("tpot", tpot), ("ttlt", ttlt)):
        summary[f"client_{name}_ms"] = float(np.mean(xs)) if xs else 0.0
        summary[f"client_{name}_p50_ms"] = _percentile(xs, 50)
        summary[f"client_{name}_p95_ms"] = _percentile(xs, 95)
    # client minus engine: both sides stamp one monotonic clock, so the
    # delta is the HTTP and submission-queue time, never negative
    d_ttft = [(r.client_ttft_s - r.engine_ttft_s) * 1e3 for r in records if r.engine]
    d_tpot = [(r.client_tpot_s - r.engine_tpot_s) * 1e3
              for r in records if r.engine and len(r.tokens) >= 2]
    summary["ttft_client_minus_engine_ms"] = float(np.mean(d_ttft)) if d_ttft else 0.0
    summary["ttft_client_minus_engine_p95_ms"] = _percentile(d_ttft, 95)
    summary["tpot_client_minus_engine_ms"] = float(np.mean(d_tpot)) if d_tpot else 0.0
    if monitor is not None:
        res = monitor.result()
        attributed = attribute_energy(records, monitor)
        summary["joules_total"] = res.joules
        summary["joules_attributed"] = attributed
        summary["avg_watts"] = res.avg_watts
        summary["joules_per_request"] = res.joules / max(len(records), 1)
        summary["joules_per_token"] = res.joules / max(total_tokens, 1)
        summary["power_samples_per_sec"] = res.samples_per_sec
        summary["power_reads_dropped"] = float(res.dropped_reads)
    return summary


async def _run_load_async(base_url: str, spec: LoadSpec, monitor=None) -> LoadResult:
    rng = np.random.default_rng(spec.seed)
    pool = [rng.integers(0, spec.vocab_size, spec.prompt_len).tolist()
            for _ in range(max(spec.prompt_pool, 1))]
    all_records: List[ClientRecord] = []
    stop = asyncio.Event()
    t_start = time.perf_counter()
    ws = t_start + spec.warmup_s
    we = ws + spec.duration_s
    window_open: List[float] = [ws, we]  # the monitor's actual edges

    async def phase_clock() -> None:
        # the monitor brackets exactly the steady-state window, so the run
        # total and the per-request tiles share one [t0, t1]
        await asyncio.sleep(max(ws - time.perf_counter(), 0.0))
        if monitor is not None:
            monitor.__enter__()
            window_open[0] = monitor.window[0]
        await asyncio.sleep(max(we - time.perf_counter(), 0.0))
        if monitor is not None:
            monitor.__exit__(None, None, None)
            window_open[1] = monitor.window[1]
        stop.set()

    async def one(idx: int) -> None:
        rec = await stream_completion(base_url, pool[idx % len(pool)],
                                      max_tokens=spec.max_new, temperature=spec.temperature,
                                      top_k=spec.top_k)
        all_records.append(rec)

    async def closed_worker(wid: int) -> None:
        i = 0
        while not stop.is_set() and len(all_records) < spec.max_requests:
            await one(wid + i * spec.concurrency)
            i += 1

    async def open_driver() -> None:
        tasks = []
        t = t_start
        k = 0
        while k < spec.max_requests:
            t += float(rng.exponential(1.0 / max(spec.qps, 1e-9)))
            if t >= we:
                break
            await asyncio.sleep(max(t - time.perf_counter(), 0.0))
            if stop.is_set():
                break
            tasks.append(asyncio.create_task(one(k)))
            k += 1
        if tasks:
            await asyncio.gather(*tasks)

    clock = asyncio.create_task(phase_clock())
    try:
        if spec.mode == "open":
            await open_driver()
        else:
            await asyncio.gather(*(closed_worker(w) for w in range(spec.concurrency)))
    finally:
        await clock

    w0, w1 = window_open
    steady = [r for r in all_records if not r.error and w0 <= r.send_time < w1]
    summary = summarize(steady, (w0, w1), monitor=monitor)
    summary["warmup_excluded"] = float(sum(1 for r in all_records if r.send_time < w0))
    summary["errors"] = float(sum(1 for r in all_records if r.error))
    return LoadResult(records=steady, all_records=all_records, window=(w0, w1),
                      summary=summary)


def run_load(base_url: str, spec: LoadSpec, monitor=None) -> LoadResult:
    """Drive ``base_url`` per ``spec`` and block until done; a
    ``PowerMonitor`` given is entered and exited at the steady-state
    window's edges, and the summary carries its energy ledger."""
    return asyncio.run(_run_load_async(base_url, spec, monitor=monitor))
