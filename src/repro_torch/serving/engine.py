"""Continuous-batching serving engine, the counterpart of
``repro/serving/engine.py`` for whole-prompt admission over a contiguous
or paged KV cache.

A request waits in a FCFS queue until a slot (and, paged, enough pool
blocks for its prompt plus its whole budget) is free.  Admission batches
every queued request of the head's prompt bucket into one prefill, left-
pads each prompt to the bucket (a longer prompt keeps its tail) and
samples the first token from the prefill's logits; what belongs to a
slot (contiguous K/V, sliding-window rings, RG-LRU states) is prefilled
fresh and scattered into the admitted slots.  Every engine step
then runs the decode step of ``serving.step`` over all ``max_batch``
slots at once (idle slots masked) and reads back one packed (3, B) int32
tensor: the step's only host sync.  On the GPU the step is one CUDA-graph
replay, captured once per engine; on the CPU it runs as it is.  Finished
requests give back their slot and blocks at once.

Per request the engine records TTFT, TPOT and TTLT, and with a
``PowerMonitor`` attached it splits the energy of each window between
requests by the tokens each emitted in it (``latency_summary``).

Chunked prefill, the unified step, prefix caching, preemption,
speculation and tensor parallelism are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.energy import PowerMonitor
from repro_torch.kernels import dispatch
from repro_torch.models import cache as cache_lib
from repro_torch.serving.sampling import SamplingParams, request_key, sample
from repro_torch.serving.step import (init_slot_state, invalidate_slot,
                                      make_decode_sample_step, write_slot)

_RING = 64  # host-side token ring buffer depth (tokens per slot per flush)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # filled by the engine:
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    truncated: bool = False
    joules: float = 0.0

    @property
    def ttft_s(self) -> float:
        return self.first_token_time - self.submit_time

    @property
    def ttlt_s(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def tpot_s(self) -> float:
        # no inter-token interval for a request that emitted <= 1 token
        n = len(self.output_tokens) - 1
        if n <= 0 or self.finish_time <= self.first_token_time:
            return 0.0
        return (self.finish_time - self.first_token_time) / n


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 for an empty list."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    k = max(int(np.ceil(len(ys) * q / 100.0)), 1) - 1
    return ys[min(k, len(ys) - 1)]


class ServingEngine:
    """Serves ``model`` (a ``models.model.Model``) on ``device``: ``cuda``
    unless the caller asks for the CPU.  ``cuda_graph=False`` runs the
    decode step without its CUDA graph, only to compare the two."""

    def __init__(
        self,
        model,
        *,
        max_batch: int = 4,
        max_len: int = 512,
        prompt_bucket: int = 32,
        seed: int = 0,
        monitor: Optional[PowerMonitor] = None,
        top_k_max: int = 64,
        cache_layout: str = "contiguous",
        kv_block_size: int = 16,
        kv_num_blocks: int = 0,
        device="cuda",
        cuda_graph: bool = True,
    ):
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout {cache_layout!r} is not 'contiguous' or 'paged'")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine on {self.device}")
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        self.layout = cache_layout
        self.seed = seed
        # static bound on per-request top-k inside the step; requests asking
        # for more are clamped, first token included
        self.top_k_max = min(top_k_max, cfg.vocab_size)
        self._itemsize = getattr(torch, cfg.dtype).itemsize

        # paged block-pool bookkeeping (host-managed free stack)
        self.block_size = kv_block_size
        self.max_blocks_per_slot = cache_lib.blocks_per_slot(max_len, kv_block_size)
        if cache_layout == "paged":
            self.num_blocks = kv_num_blocks or cache_lib.default_num_blocks(
                max_batch, max_len, kv_block_size)
            min_blocks = self.max_blocks_per_slot + 1
            if self.num_blocks < min_blocks:
                raise ValueError(
                    f"--kv-num-blocks={self.num_blocks} is too small: max_len={max_len} "
                    f"at block size {kv_block_size} needs {self.max_blocks_per_slot} "
                    f"blocks for one worst-case request, plus the reserved garbage "
                    f"block 0 — pass --kv-num-blocks >= {min_blocks} (or 0 for the "
                    f"worst-case default of "
                    f"{cache_lib.default_num_blocks(max_batch, max_len, kv_block_size)})")
        else:
            self.num_blocks = 0
        self._pool = cache_lib.BlockPool(max(self.num_blocks, 1))
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self.peak_blocks_in_use = 0
        self._occ_samples: List[float] = []

        self.cache = model.init_cache(max_batch, max_len, layout=cache_layout,
                                      block_size=kv_block_size, num_blocks=self.num_blocks)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: deque = deque()
        self.finished: List[Request] = []
        self._uid = 0

        # device-dispatch accounting: admission prefills and decode steps
        # (graph replays), the counterpart of the reference's jitted launches
        self._dispatches = 0
        self._dispatch_samples: List[int] = []
        self.prefills = 0
        self.decode_forwards = 0
        self._decode_tokens = 0
        self._decode_dispatches = 0
        self._steps_done = 0
        self._steps_t0: Optional[float] = None
        self._steps_t1 = 0.0

        self._state = init_slot_state(
            max_batch, self.max_blocks_per_slot if cache_layout == "paged" else 0,
            self.device)
        self._step = make_decode_sample_step(model, max_len, k_max=self.top_k_max)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        if cuda_graph and self.device.type == "cuda":
            self._capture()

        # host-side token ring buffer: (max_batch, _RING) plus fill counts
        self._ring = np.zeros((max_batch, _RING), np.int32)
        self._ring_n = np.zeros(max_batch, np.int64)

        # energy attribution
        self.monitor = monitor
        self._win_t0: Optional[float] = None
        self._win_tokens: Dict[int, int] = {}
        self.attributed_joules = 0.0

        # token streaming: (uid, new_tokens, finished), called the moment
        # tokens leave the device, before the ring buffer defers them
        self.stream_hook: Optional[Callable[[int, List[int], bool], None]] = None

    # -- the decode step as a CUDA graph ------------------------------------------
    def _capture(self) -> None:
        """Capture the decode step once (``dispatch.capture_graph``).  Its
        two warm-up runs find every slot idle, so they change nothing but
        the garbage block."""
        self._graph, self._graph_out, self._graph_launches = dispatch.capture_graph(
            lambda: self._step(self._state, self.cache), self.device)

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, params: Optional[SamplingParams] = None) -> int:
        params = params or SamplingParams()
        if params.top_k > self.top_k_max:
            params = dataclasses.replace(params, top_k=self.top_k_max)
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32), params=params)
        req.submit_time = time.perf_counter()
        self._uid += 1
        self.queue.append(req)
        return req.uid

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def step(self) -> bool:
        """One admit + decode round; returns True if work was done."""
        if not self.busy:
            return False
        t0 = time.perf_counter()
        d0 = self._dispatches
        self._admit()
        self._decode_once()
        if self.layout == "paged":
            self._occ_samples.append(self._pool.in_use / max(self.num_blocks - 1, 1))
        if self._steps_t0 is None:
            self._steps_t0 = t0
        self._steps_t1 = time.perf_counter()
        self._steps_done += 1
        self._dispatch_samples.append(self._dispatches - d0)
        return True

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until queue and slots drain (or the step budget); returns
        the finished requests."""
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        self.flush()
        return self.finished

    def flush(self) -> None:
        """Drain the ring-buffered tokens of still-running requests and the
        open energy-attribution window."""
        for slot in range(self.max_batch):
            self._flush_ring(slot)
        self._flush_energy()

    def attach_monitor(self, monitor: PowerMonitor) -> None:
        """Start attributing the monitor's energy to requests from now on."""
        self.monitor = monitor
        self._win_t0 = None
        self._win_tokens = {}

    # -- admission ----------------------------------------------------------------
    def _bucketed(self, n: int) -> int:
        b = self.prompt_bucket
        return min(self.max_len - 1, ((n + b - 1) // b) * b)

    def _blocks_for(self, plen: int, max_new: int) -> int:
        """Pool blocks reserved at admission: the prompt plus the whole
        decode budget, so the decode step never has to allocate."""
        tokens = min(plen + max_new, self.max_len)
        return min(cache_lib.blocks_per_slot(tokens, self.block_size),
                   self.max_blocks_per_slot)

    @property
    def blocks_in_use(self) -> int:
        return self._pool.in_use if self.layout == "paged" else 0

    def _padded_prompt(self, req: Request, plen: int) -> np.ndarray:
        """The bucketed, left-padded token row admission prefills (a prompt
        longer than the bucket keeps its newest tokens)."""
        use = req.prompt
        if len(use) > plen:
            use = use[-plen:]
            req.truncated = True
        toks = np.zeros(plen, np.int32)
        toks[plen - len(use):] = use
        return toks

    def _admit(self) -> None:
        while self.queue:
            free = [s for s in range(self.max_batch) if self.slots[s] is None]
            if not free:
                return
            # the head of the queue sets the prompt bucket; every queued
            # request of that bucket joins, in FCFS order, up to the free
            # slots and (paged) the free blocks.  A head that does not fit
            # in the pool blocks admission: strict FCFS backpressure.
            plen = self._bucketed(len(self.queue[0].prompt))
            picked: List[Request] = []
            blocks_reserved = 0
            for req in self.queue:
                if len(picked) == len(free):
                    break
                if self._bucketed(len(req.prompt)) != plen:
                    continue
                if self.layout == "paged":
                    nb = self._blocks_for(plen, req.params.max_new_tokens)
                    if blocks_reserved + nb > self._pool.available:
                        break
                    blocks_reserved += nb
                picked.append(req)
            if not picked:
                return  # pool backpressure: wait for finishes to free blocks
            picked_ids = {id(r) for r in picked}
            self.queue = deque(r for r in self.queue if id(r) not in picked_ids)
            self._admit_batch(picked, free[:len(picked)], plen)

    def _admission_cache(self, n: int):
        """The cache an admission prefill of ``n`` rows fills: the live pool
        of every paged layer (shared by all slots; the prefill writes the
        prompts' K/V into their blocks), a fresh ``n``-row entry for every
        per-slot layer (contiguous K/V, sliding-window rings, recurrent
        states), so each admitted row starts from zeros."""
        dtype = getattr(torch, self.cfg.dtype)
        return [entry if "kp" in entry else
                cache_lib.init_block_cache(self.cfg, blk.kind, n, self.max_len, dtype,
                                           self.device)
                for blk, entry in zip(self.model.layers, self.cache)]

    def _merge_admitted(self, part, slots_for: List[int]) -> None:
        """Row ``r`` of each fresh per-slot entry lands in slot
        ``slots_for[r]``, one scatter per leaf, in place (the tensors the
        CUDA graph captured stay the live ones).  Pools were written in
        place already; scalars such as ``ring`` pass through."""
        rows = torch.tensor(slots_for, device=self.device)
        for entry, new in zip(self.cache, part):
            if new is entry:
                continue
            for leaf, t in new.items():
                if t.dim() > 0:
                    entry[leaf][rows] = t

    def _admit_batch(self, reqs: List[Request], slots_for: List[int], plen: int) -> None:
        """One prefill for ``reqs`` (all bucketed to ``plen``) into
        ``_admission_cache``, then into the slots (``_merge_admitted``), as
        the reference's merge does.  Paged: the prompts' K/V go straight
        into their pool blocks."""
        n = len(reqs)
        tokens = torch.from_numpy(np.stack([self._padded_prompt(r, plen) for r in reqs]))
        batch = {"tokens": tokens.to(self.device)}
        tables_np, tables = None, None
        if self.layout == "paged":
            tables_np = np.zeros((n, self.max_blocks_per_slot), np.int32)
            for r, (req, slot) in enumerate(zip(reqs, slots_for)):
                nb = self._blocks_for(plen, req.params.max_new_tokens)
                blocks = self._pool.allocate(nb)
                tables_np[r, :nb] = blocks
                self._slot_blocks[slot] = blocks
            self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)
            tables = torch.from_numpy(tables_np).to(self.device)
        part = self._admission_cache(n)
        logits, part = self.model.prefill(batch, part, block_tables=tables)
        self._merge_admitted(part, slots_for)
        self._dispatches += 1
        self.prefills += 1
        for r, (req, slot) in enumerate(zip(reqs, slots_for)):
            self.slots[slot] = req
            self._start_decoding(req, slot, plen, logits[r:r + 1],
                                 None if tables_np is None else tables_np[r])

    def _start_decoding(self, req: Request, slot: int, plen: int, logits,
                        table_row: Optional[np.ndarray]) -> None:
        """Sample the first token (draw 0 of the request's stream) and arm
        the slot's device row; its decode draws continue from draw 1."""
        key = request_key(self.seed, req.uid)
        first = int(sample(logits, req.params, key, index=0)[0])
        req.first_token_time = time.perf_counter()
        req.output_tokens.append(first)
        self._count_token(req)
        self._notify_stream(req, [first])

        done = (req.params.max_new_tokens <= 1
                or (req.params.eos_token >= 0 and first == req.params.eos_token)
                or plen >= self.max_len - 1)
        write_slot(self._state, slot, token=first, position=plen,
                   remaining=req.params.max_new_tokens - 1, params=req.params,
                   active=not done, key=key, count=1)
        if table_row is not None:
            self._state["block_tables"][slot].copy_(torch.from_numpy(table_row))
        if done:
            self._finish(slot)

    # -- decode -------------------------------------------------------------------
    def _decode_once(self) -> None:
        if not any(req is not None for req in self.slots):
            return
        if self._graph is not None:
            self._graph.replay()
            out = self._graph_out
            dispatch.credit(self._graph_launches)
        else:
            out = self._step(self._state, self.cache)
        self._dispatches += 1
        self.decode_forwards += 1
        self._process_decode_out(out.cpu().numpy())  # the step's one host sync

    def _process_decode_out(self, out_np: np.ndarray) -> None:
        tokens, done, emitted = out_np[0], out_np[1], out_np[2]
        any_emit = False
        for slot in np.nonzero(emitted)[0]:
            req = self.slots[slot]
            if req is None:
                continue
            any_emit = True
            self._decode_tokens += 1
            n = int(self._ring_n[slot])
            self._ring[slot, n] = tokens[slot]
            self._ring_n[slot] = n + 1
            if n + 1 == _RING:
                self._flush_ring(slot)
            self._count_token(req)
            self._notify_stream(req, [int(tokens[slot])])
            if done[slot]:
                self._finish(slot)
        if any_emit:
            self._decode_dispatches += 1

    def _notify_stream(self, req: Request, tokens: List[int], finished: bool = False) -> None:
        if self.stream_hook is not None:
            self.stream_hook(req.uid, tokens, finished)

    def _flush_ring(self, slot: int) -> None:
        n = int(self._ring_n[slot])
        req = self.slots[slot]
        if req is not None and n:
            req.output_tokens.extend(int(t) for t in self._ring[slot, :n])
        self._ring_n[slot] = 0

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        self._flush_ring(slot)
        req.finish_time = time.perf_counter()
        self.finished.append(req)
        self.slots[slot] = None
        invalidate_slot(self._state, slot, garbage_block=cache_lib.GARBAGE_BLOCK)
        if self._slot_blocks[slot]:
            self._pool.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
        self._flush_energy()
        # after _flush_energy: the finish edge carries the final joules share
        self._notify_stream(req, [], finished=True)

    # -- memory accounting --------------------------------------------------------
    def kv_bytes_in_use(self, peak: bool = False) -> int:
        """Attention KV bytes the engine holds: paged, the blocks in use (or
        their high-water mark); contiguous, every slot's ``max_len`` stripe,
        allocated up front whatever the load."""
        if self.layout == "paged":
            blocks = self.peak_blocks_in_use if peak else self.blocks_in_use
            return self._n_attn_layers * blocks * self.block_size * self._kv_tok_bytes
        return self.kv_bytes_worst_case

    @property
    def kv_bytes_worst_case(self) -> int:
        return self._n_attn_layers * self.max_batch * self.max_len * self._kv_tok_bytes

    @property
    def _n_attn_layers(self) -> int:
        return sum(1 for kind in self.cfg.blocks() if kind == "attn")

    @property
    def _kv_tok_bytes(self) -> int:
        return 2 * self.cfg.num_kv_heads * self.cfg.resolved_head_dim * self._itemsize

    # -- energy attribution -------------------------------------------------------
    def _count_token(self, req: Request) -> None:
        if self.monitor is None:
            return
        if self._win_t0 is None:
            t0 = self.monitor.window[0]
            self._win_t0 = t0 if t0 > 0.0 else time.perf_counter()
        self._win_tokens[req.uid] = self._win_tokens.get(req.uid, 0) + 1

    def _flush_energy(self) -> None:
        """Close the current window: split its joules by token counts."""
        if self.monitor is None or self._win_t0 is None:
            return
        t1 = time.perf_counter()
        joules = self.monitor.joules_between(self._win_t0, t1)
        total = sum(self._win_tokens.values())
        if total > 0 and joules > 0.0:
            by_uid = {r.uid: r for r in self.finished}
            for s in self.slots:
                if s is not None:
                    by_uid[s.uid] = s
            for uid, n in self._win_tokens.items():
                share = joules * n / total
                if uid in by_uid:
                    by_uid[uid].joules += share
                self.attributed_joules += share
        self._win_t0 = t1
        self._win_tokens = {}

    # -- metrics ------------------------------------------------------------------
    def latency_summary(self) -> Dict[str, float]:
        if not self.finished:
            return {}
        ttfts = [r.ttft_s for r in self.finished]
        tpots = [r.tpot_s for r in self.finished]
        ttlts = [r.ttlt_s for r in self.finished]

        def mean(xs):
            return sum(xs) / len(xs)

        out_tokens = sum(len(r.output_tokens) for r in self.finished)
        t_first = min(r.submit_time for r in self.finished)
        t_last = max(r.finish_time for r in self.finished)
        span = max(t_last - t_first, 1e-9)
        prefill_tokens = sum(min(len(r.prompt), self.max_len - 1) for r in self.finished)
        summary = {
            "requests": len(self.finished),
            "truncated": sum(1 for r in self.finished if r.truncated),
            "output_tokens": out_tokens,
            "tokens_per_sec": out_tokens / span,
            "decode_tokens_per_sec": out_tokens / span,
            "prefill_tokens_per_sec": prefill_tokens / span,
            "tokens_per_dispatch": self._decode_tokens / max(self._decode_dispatches, 1),
            "ttft_ms": mean(ttfts) * 1e3,
            "tpot_ms": mean(tpots) * 1e3,
            "ttlt_ms": mean(ttlts) * 1e3,
        }
        for name, xs in (("ttft", ttfts), ("tpot", tpots), ("ttlt", ttlts)):
            for q in (50, 95, 99):
                summary[f"{name}_p{q}_ms"] = _percentile(xs, q) * 1e3
        summary["kv_bytes_peak"] = self.kv_bytes_in_use(peak=True)
        summary["kv_bytes_worst_case"] = self.kv_bytes_worst_case
        if self._steps_done:
            wall = max(self._steps_t1 - (self._steps_t0 or 0.0), 1e-9)
            summary["steps_per_sec"] = self._steps_done / wall
            summary["dispatches_per_step_p50"] = _percentile(self._dispatch_samples, 50)
            summary["dispatches_per_step_p95"] = _percentile(self._dispatch_samples, 95)
        if self.layout == "paged":
            # preemption is not ported: nothing is ever preempted or recomputed
            summary["preemptions"] = 0
            summary["recompute_tokens"] = 0
            summary["pool_occupancy_p50"] = _percentile(self._occ_samples, 50)
            summary["pool_occupancy_p95"] = _percentile(self._occ_samples, 95)
        if self.monitor is not None:
            total_j = sum(r.joules for r in self.finished)
            summary["joules_total"] = total_j
            summary["joules_per_request"] = total_j / max(len(self.finished), 1)
            summary["joules_per_token"] = total_j / max(out_tokens, 1)
            res = self.monitor.result()
            summary["power_samples_per_sec"] = res.samples_per_sec
            summary["power_reads_dropped"] = res.dropped_reads
        return summary
