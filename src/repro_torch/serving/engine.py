"""Continuous-batching serving engine, the counterpart of
``repro/serving/engine.py``: whole-prompt or Sarathi-style chunked
admission over a contiguous or paged KV cache, with block-level prefix
caching on the paged one.

A request waits in a FCFS queue until a slot (and, paged, enough pool
blocks for its prompt plus its whole budget, or under preemption for its
prompt and first decode write) is free.  Admission batches
every queued request of the head's prompt bucket.  Prompts are padded to
the bucket on the left (a longer prompt keeps its tail), or on the right
with ``pad_side="right"``, where each row is computed only as far as its
prompt goes.

* Whole-prompt admission (``prefill_chunk=0``): one prefill, whose
  per-slot rows (contiguous K/V, sliding-window rings, recurrent states) are
  prefilled fresh and scattered into the admitted slots; the first token
  is sampled from its logits.
* Chunked prefill (``prefill_chunk > 0``): admission only reserves the
  slot (and blocks) and opens a cursor; the slots' rows are reset in one
  batched ``reset_rows`` per step.  Every step then spends a budget of
  ``prefill_budget`` prompt tokens on the cursors, FCFS, so no step waits
  on more prompt work than that.  With ``unified_step`` (the default) the
  chunks of every cursor the budget reaches and the decode of every
  armed slot run as one step (``step.make_engine_step``); without it,
  each chunk runs on its own before the decode step.  A cursor's first
  token is sampled once its last chunk lands.
* Prefix caching (``prefix_cache=True``, paged, attention-only models):
  full prompt blocks are hashed (``cache.hash_token_blocks``) and shared
  read-only through the pool's refcounts, so a request whose prefix is
  resident starts at its first uncached block.  The block holding the last
  prompt position is always recomputed privately, so decode never writes
  a shared block.
* Preemption with recompute (``preemption="recompute"``, paged): blocks
  are reserved lazily and grown as decodes cross block boundaries
  (``_grow_decode_blocks``); when the pool runs dry the newest admitted
  request, never the head of line, is preempted: its blocks are freed
  (shared prefix blocks lose a reference) and it is parked.  Parked
  requests are re-admitted first, oldest first, by recomputing the
  prompt and the tokens they had emitted through the chunk path, and
  resume with the draw index they would have had, so every stream,
  greedy or sampled, equals the uncontended run's.
* Prompt-lookup speculative decoding (``speculative="lookup"``,
  attention-only models): each step the host drafts up to
  ``spec_tokens`` tokens per slot from the request's own history
  (``prompt_lookup_draft``), and the verify step
  (``step.make_spec_decode_step``) scores every window in one forward
  and emits 1 + the accepted draft tokens.  The emitted tokens are the
  model's own draws, so the streams equal those without speculation;
  only the tokens per step change.

Every engine step runs the decode step over all ``max_batch`` slots at
once (idle and prefilling slots masked) and reads back one packed int32
tensor: the step's only host sync.  On the GPU the decode step and the
unified step are each one CUDA-graph replay, captured once per engine
(the unified one at its width W = min(budget, max_len - 1)); on the CPU
they run as they are.  Dispatches are counted as the reference counts its
launches: a whole-prompt prefill, a row reset, a chunk, a decode, verify
or unified step and a resumed request's draw index each count one.
Finished requests give back their slot and blocks at once.

A vision model (llava-next-34b) is served with zero patch embeddings, as
the reference serves it, before each prompt: whole-prompt or chunked
admission (the per-chunk path, never the unified step; the patches ride
with the first chunk), either layout.  Its decode starts at position
``num_vision_tokens`` + prompt, and the blocks, the bucket cap and the
``max_len`` check count the patches: the reference starts it at the
prompt's length, where it overwrites the prompt's own keys.  Speculation,
right padding, preemption and the prefix cache are refused for it, as the
reference refuses them.  An encoder-decoder model is refused: the
reference's engine sizes the cross memory at ``max_len // 2`` and fails
to merge an admitted prompt's shorter one, so it serves none.

Per request the engine records TTFT, TPOT and TTLT, and with a
``PowerMonitor`` attached it splits the energy of each window between
requests by the tokens each emitted in it (``latency_summary``).

Tensor parallelism (``mesh=``, a ``launch.mesh.TPMesh``) runs SPMD: one
engine per rank, each over its rank's shard of the model
(``sharding.partition.shard_model``) and a cache of its shard of each leaf
(``Model.init_cache``: its KV heads, or its slots of every head where tp
does not divide them, or a replicated pool; its recurrent states' heads or
width), all in lockstep, forced by the collectives inside every forward pass.  Two
rules keep the ranks' host decisions equal, so admission, chunking,
preemption, the prefix cache and the drafts follow on every rank from the
same inputs, as in the reference's single controller:

* requests are submitted on rank 0 only: each ``step()`` on rank 0 opens
  with one host broadcast (gloo) of the requests submitted since the last
  step, with their submit stamps; ranks > 0 run ``follow()``, which
  receives each step's requests and runs the step, until rank 0's
  ``close()``; they never read the clock to decide anything;
* tokens are picked from replicated logits: the vocabulary-parallel head
  gathers the full row on every rank, so greedy picks and the
  counter-based draws agree.

The broadcast is host work, not a device dispatch; its time per step is
in the summary (``tp_broadcast_us_p50``/``_p95``).  The per-device ledgers
(``kv_bytes_by_device``, ``pool_accounting_by_device``) come from every
rank's own cache leaves and pool, gathered to rank 0 on demand: a
replicated pool counts whole on every rank, an L-sharded cache its slice
(replication is real memory, as the reference counts it).  A gloo
mesh cannot be captured in a CUDA graph, so ``cuda_graph=True`` on one
raises; on NCCL the steps are captured as on one device.
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
from repro_torch.serving.step import (CHUNK_FIELDS, init_slot_state, invalidate_slot,
                                      make_decode_sample_step, make_engine_step,
                                      make_spec_decode_step, pack_chunk, write_slot)

_RING = 64  # host-side token ring buffer depth (tokens per slot per flush)


def prompt_lookup_draft(hist: List[int], k: int, ngram_max: int = 3) -> List[int]:
    """Drafting without a draft model: the ``k`` tokens that followed an
    earlier occurrence of the stream's trailing n-gram, the longest n
    first (``ngram_max`` down to 1).  Among the occurrences of the longest
    n-gram that matches, the most recent one with a full ``k``-token
    continuation wins, else the one with the longest continuation; ``[]``
    when nothing matches (the verify step then emits one token, as a
    decode step does).  A draft only decides how many tokens a verify
    step may emit, never which."""
    L = len(hist)
    if k <= 0 or L < 2:
        return []
    for n in range(min(ngram_max, L - 1), 0, -1):
        pat = hist[L - n:]
        best = None  # (continuation length, match index)
        for i in range(L - n - 1, -1, -1):
            if hist[i:i + n] == pat:
                c = min(k, L - i - n)
                if c == k:
                    best = (c, i)
                    break
                if best is None or c > best[0]:
                    best = (c, i)
        if best is not None:
            c, i = best
            return hist[i + n:i + n + c]
    return []


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
    # order of first admission, kept across re-admissions, so the oldest
    # request in flight (the head of line) is never a victim; -1: never
    # admitted
    admit_seq: int = -1
    preemptions: int = 0
    # (plen, block hashes), memoized: admission may probe a request that
    # waits on the pool every step
    _hash_cache: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                     compare=False)

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


@dataclasses.dataclass
class _PrefillCursor:
    """A slot's chunked-prefill progress (its third state, between free
    and decoding)."""
    req: Request
    tokens: np.ndarray                       # (bucket,) the padded prompt row
    plen: int                                # positions to compute (the span)
    next: int = 0                            # next position to prefill
    tables_np: Optional[np.ndarray] = None   # (max_blocks,) paged table row
    # prefix cache: (end position, block) of each block this cursor
    # registered, marked ready once the cursor has passed its end
    pending_ready: List = dataclasses.field(default_factory=list)
    # recompute after a preemption: the tokens the request had emitted (0:
    # a fresh admission, whose first token comes from the last chunk; > 0:
    # the slot resumes with its last emitted token)
    resume_n: int = 0


class ServingEngine:
    """Serves ``model`` (a ``models.model.Model``) on ``device``: ``cuda``
    unless the caller asks for the CPU.  ``cuda_graph=False`` runs the
    decode and unified steps without their CUDA graphs, only to compare
    the two."""

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
        prefill_chunk: int = 0,
        prefill_budget: int = 0,
        prefix_cache: bool = False,
        unified_step: bool = True,
        pad_side: str = "left",
        preemption: str = "off",
        speculative: str = "off",
        spec_tokens: int = 4,
        mesh=None,
        shard_rules=None,
        param_axes=None,
    ):
        if shard_rules is not None or param_axes is not None:
            raise TypeError(
                "shard_rules= and param_axes= place a JAX parameter tree by its logical axes; "
                "the port shards by hand: pass the rank's shard "
                "(sharding.partition.shard_model) and its mesh=")
        if mesh is not None:
            if getattr(model, "mesh", None) is not mesh:
                raise ValueError("mesh= needs the rank's shard of the model over that mesh "
                                 "(sharding.partition.shard_model(cfg, mesh))")
            if cuda_graph and torch.device(device).type == "cuda" and not mesh.capturable:
                raise ValueError(
                    f"cuda_graph=True cannot capture the collectives of a {mesh.backend} mesh; "
                    f"pass cuda_graph=False to run its steps eagerly, or use NCCL")
        self.mesh = mesh
        if model.cfg.is_encdec:
            raise ValueError(
                f"{model.cfg.name!r} is an encoder-decoder model, which the reference's "
                f"ServingEngine cannot serve: it sizes the cross memory at max_len // 2, "
                f"the prefill replaces it with the prompt's own plen // 2 rows, and the "
                f"admitted rows then fail to merge into the slots; measure it through "
                f"Elana.measure instead")
        nv = model.cfg.num_vision_tokens
        if cache_layout not in ("contiguous", "paged"):
            raise ValueError(f"cache_layout {cache_layout!r} is not 'contiguous' or 'paged'")
        if nv and max_len <= nv + 1:
            raise ValueError(
                f"max_len={max_len} leaves no prompt token and decode position after "
                f"{model.cfg.name!r}'s vision prefix of {nv} patch embeddings; "
                f"give max_len > {nv + 1}")
        if pad_side == "right" and nv:
            raise ValueError(
                f"pad_side='right' realigns the bucketed prompt row so variable-length "
                f"suffixes of a shared prefix land on the same block boundaries; "
                f"{model.cfg.name!r} carries a vision prefix whose position bookkeeping "
                f"assumes the whole padded row is computed")
        if pad_side not in ("left", "right"):
            raise ValueError(f"pad_side {pad_side!r} is not 'left' or 'right'")
        if speculative not in ("off", "lookup"):
            raise ValueError(f"speculative must be 'off' or 'lookup', got {speculative!r}")
        self.spec_k = int(spec_tokens) if speculative != "off" else 0
        if speculative != "off":
            if self.spec_k < 1:
                raise ValueError(f"--spec-tokens={spec_tokens} must be >= 1 when "
                                 f"--speculative is on")
            bad = sorted({k for k in model.cfg.blocks() if k not in ("attn", "ffn")})
            if bad or nv:
                raise ValueError(
                    f"speculative='lookup' relies on rejected draft suffixes being "
                    f"re-writable cache positions, which only full-attention KV supports; "
                    f"{model.cfg.name!r} carries per-slot state that cannot rewind "
                    f"({', '.join(bad) or 'vision prefix'})")
        if preemption not in ("off", "recompute"):
            raise ValueError(f"preemption must be 'off' or 'recompute', got {preemption!r}")
        if preemption != "off" and cache_layout != "paged":
            raise ValueError("preemption requires cache_layout='paged': only a block pool "
                             "can run dry mid-decode and reclaim a victim's blocks")
        if preemption != "off" and nv:
            raise ValueError(
                f"preemption='recompute' replays a request's prompt + generated tokens "
                f"through the chunked-prefill path; {model.cfg.name!r} carries a vision "
                f"prefix whose replay length would differ from the original admission")
        self.preemption = preemption
        if prefix_cache:
            if cache_layout != "paged":
                raise ValueError("prefix_cache requires cache_layout='paged': only pool blocks "
                                 "can be shared read-only across requests")
            bad = sorted({k for k in model.cfg.blocks() if k not in ("attn", "ffn")})
            if bad or nv:
                raise ValueError(
                    f"prefix_cache shares paged full-attention KV blocks only; "
                    f"{model.cfg.name!r} carries per-slot state that a skipped prefill "
                    f"would leave stale ({', '.join(bad) or 'vision prefix'})")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine on {self.device}")
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        self.nv = nv  # positions of the vision prefix before each prompt
        self.max_batch = max_batch
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket
        self.layout = cache_layout
        self.seed = seed
        self.pad_side = pad_side
        self.prefix_cache = prefix_cache
        # chunked prefill: 0 is whole-prompt admission; the budget is prompt
        # tokens of chunk work per step, at least one chunk (a smaller one
        # would never fit the head cursor's next chunk)
        self.chunk = max(int(prefill_chunk), 0)
        self.chunk_budget = max(int(prefill_budget) or self.chunk, self.chunk)
        # a vision prefix rides with a slot's first chunk: the per-chunk path
        self.unified = bool(unified_step) and self.chunk > 0 and not nv
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
        # prefix-cache counters (latency_summary)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_blocks_reused = 0
        self.prefill_tokens_skipped = 0
        # preemption: parked requests (oldest admission first, re-admitted
        # ahead of the queue), the counters, and the host mirror of each
        # decoding slot's next write position, which block growth reads
        self._preempted: List[Request] = []
        self._admit_seq = 0
        self.preemptions = 0
        self.recompute_tokens = 0
        self._next_pos = np.zeros(max_batch, np.int64)
        # speculation: drafter counters, and each slot's uploaded draft
        # length (block growth covers the verify window's writes)
        self._drafted_tokens = 0
        self._accepted_tokens = 0
        self._spec_verifies = 0
        self._draft_len_host = np.zeros(max_batch, np.int64)

        self.cache = model.init_cache(max_batch, max_len, layout=cache_layout,
                                      block_size=kv_block_size, num_blocks=self.num_blocks)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # chunked prefill: _cursors[s] is set while slot s prefills;
        # _prefill_order is their FCFS service order
        self._cursors: List[Optional[_PrefillCursor]] = [None] * max_batch
        self._prefill_order: List[int] = []
        self._pending_reset: List[int] = []  # slots admitted this step
        self.queue: deque = deque()
        self.finished: List[Request] = []
        self._uid = 0

        # device-dispatch accounting, the counterpart of the reference's
        # jitted launches; and the forward passes the kernels ran: whole
        # prefills, chunk passes (one per chunk, verify step or unified
        # step, two for a unified step with speculation) and decode passes
        # (one per decode or unified step without speculation), graph
        # replays included
        self._dispatches = 0
        self._dispatch_samples: List[int] = []
        self.prefills = 0
        self.chunk_forwards = 0
        self.decode_forwards = 0
        self._decode_tokens = 0
        self._decode_dispatches = 0
        self._steps_done = 0
        self._steps_t0: Optional[float] = None
        self._steps_t1 = 0.0

        self._state = init_slot_state(
            max_batch, self.max_blocks_per_slot if cache_layout == "paged" else 0,
            self.device, spec_k=self.spec_k)
        if self.spec_k:
            self._step = make_spec_decode_step(model, max_len, k_max=self.top_k_max)
        else:
            self._step = make_decode_sample_step(model, max_len, k_max=self.top_k_max)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._unified_graph: Optional[torch.cuda.CUDAGraph] = None
        if self.unified:
            # the packed frontier's static width: the budget bounds a step's
            # chunk work, and no cursor holds more than max_len - 1 tokens
            width = min(self.chunk_budget, max(max_len - 1, 1))
            self._unified_step = make_engine_step(model, max_len, k_max=self.top_k_max,
                                                  spec_k=self.spec_k)
            self._chunk_buf = torch.zeros((max_batch, width + len(CHUNK_FIELDS)),
                                          dtype=torch.int32, device=self.device)
        if cuda_graph and self.device.type == "cuda":
            if mesh is not None:
                mesh.warm()  # the communicator exists before the capture
            self._capture()

        # tensor parallelism: requests submitted on rank 0 since its last
        # step (broadcast by the next), each step's broadcast time there,
        # and whether a rank > 0 was released from ``follow``
        self._outbox: List[Request] = []
        self._bcast_s: List[float] = []
        self._closed = False

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

    # -- the steps as CUDA graphs --------------------------------------------------
    def _capture(self) -> None:
        """Capture the decode (or verify) step, and the unified step at its
        width, once each (``dispatch.capture_graph``).  Their warm-up runs
        find every slot idle and every chunk row empty, so they change
        nothing but the garbage block."""
        self._graph, self._graph_out, self._graph_launches = dispatch.capture_graph(
            lambda: self._step(self._state, self.cache), self.device)
        if self.unified:
            self._unified_graph, self._unified_out, self._unified_launches = \
                dispatch.capture_graph(
                    lambda: self._unified_step(self._state, self._chunk_buf, self.cache),
                    self.device)

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, params: Optional[SamplingParams] = None) -> int:
        if not self.leader:
            raise RuntimeError(f"requests are submitted on rank 0 only; rank "
                               f"{self.mesh.rank} runs follow()")
        params = params or SamplingParams()
        if params.top_k > self.top_k_max:
            params = dataclasses.replace(params, top_k=self.top_k_max)
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32), params=params)
        req.submit_time = time.perf_counter()
        self._uid += 1
        self.queue.append(req)
        if self.mesh is not None:
            self._outbox.append(req)
        return req.uid

    # -- tensor parallelism: rank 0 leads, the other ranks follow --------------
    @property
    def leader(self) -> bool:
        """Rank 0 of the mesh, or an engine without one."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def n_devices(self) -> int:
        """Devices the engine shards over (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.size

    def _command(self, cmd: str, arg=None) -> None:
        """Rank 0: send the other ranks their next command."""
        self.mesh.broadcast_object((cmd, arg))

    def follow(self) -> None:
        """Ranks > 0: run what rank 0 runs, step for step (each with the
        requests rank 0 was given since its last step, stamped as it
        stamped them), and answer its ledger requests, until its
        ``close()``."""
        if self.leader:
            raise RuntimeError("follow() runs on ranks > 0 of a mesh")
        while True:
            cmd, arg = self.mesh.broadcast_object()
            if cmd == "close":
                self._closed = True
                return
            if cmd == "step":
                for uid, prompt, params, stamp in arg:
                    self.queue.append(Request(uid=uid, prompt=prompt, params=params,
                                              submit_time=stamp))
                self._round()
            elif cmd == "ledger":
                self.mesh.gather_objects(self._local_ledger(arg))
            else:
                raise RuntimeError(f"unknown command {cmd!r} from rank 0")

    def close(self) -> None:
        """Rank 0: release the other ranks from ``follow``.  A no-op
        without a mesh, elsewhere than on rank 0, or when done already."""
        if self.mesh is not None and self.leader and not self._closed:
            self._closed = True
            self._command("close")

    @property
    def busy(self) -> bool:
        return (bool(self.queue) or bool(self._preempted)
                or any(s is not None for s in self.slots))

    def step(self) -> bool:
        """One admit + chunk + decode round; returns True if work was done.
        With the unified step the FCFS chunk frontier is picked on the host
        first and then advanced with the decode in one dispatch; without
        it each chunk is a dispatch of its own before the decode step.
        Drafts are armed and blocks grown (preempting if the pool is dry)
        right before the dispatch.  On rank 0 of a mesh the step opens with
        the host broadcast that starts the same step on every rank."""
        if self.mesh is not None:
            if not self.leader:
                raise RuntimeError("ranks > 0 of a mesh step in follow()")
            if self._closed:
                raise RuntimeError("the engine's mesh was released by close()")
            t0 = time.perf_counter()
            self._command("step", [(r.uid, r.prompt, r.params, r.submit_time)
                                   for r in self._outbox])
            self._outbox = []
            self._bcast_s.append(time.perf_counter() - t0)
        return self._round()

    def _round(self) -> bool:
        if not self.busy:
            return False
        t0 = time.perf_counter()
        d0 = self._dispatches
        self._admit()
        self._flush_resets()  # one batched row reset per step
        if self.unified:
            frontier = self._pick_frontier()
            if self.spec_k:
                self._arm_drafts()
            self._grow_decode_blocks()
            self._unified_once(frontier)
        else:
            self._advance_chunks()
            if self.spec_k:
                self._arm_drafts()
            self._grow_decode_blocks()
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
    def _flush_resets(self) -> None:
        """Reset the rows of the slots admitted this step, as one dispatch.
        It counts as one also when the cache has no per-slot leaf to reset
        (a paged attention-only model), as the reference counts its launch."""
        if self._pending_reset:
            slots, self._pending_reset = self._pending_reset, []
            cache_lib.reset_rows(self.cache, torch.tensor(slots, device=self.device))
            self._dispatches += 1

    def _bucketed(self, n: int) -> int:
        """The prompt bucket of an ``n``-token prompt, capped so that the
        vision prefix and the bucket leave a position to decode."""
        b = self.prompt_bucket
        return min(self.max_len - 1 - self.nv, ((n + b - 1) // b) * b)

    def _blocks_for(self, plen: int, max_new: int) -> int:
        """Pool blocks reserved at admission: the vision prefix, the prompt
        and the whole decode budget, so the decode step never has to
        allocate; under ``preemption="recompute"`` only the prompt and the
        first decode write, the rest grown on demand
        (``_grow_decode_blocks``)."""
        budget = 1 if self.preemption != "off" else max_new
        tokens = min(self.nv + plen + budget, self.max_len)
        return min(cache_lib.blocks_per_slot(tokens, self.block_size),
                   self.max_blocks_per_slot)

    @property
    def blocks_in_use(self) -> int:
        """Blocks owned by live requests; evictable cached blocks, kept only
        for future prefix hits, do not count."""
        return self._pool.in_use if self.layout == "paged" else 0

    def _padded_prompt(self, req: Request, plen: int) -> np.ndarray:
        """The bucketed token row admission prefills (a prompt longer than
        the bucket keeps its newest tokens): zero-padded on the left, so
        the tokens end at the bucket's end, or with ``pad_side="right"`` on
        the right, so prompts that share a prefix hash to the same block
        chain whatever their suffix lengths."""
        use = req.prompt
        if len(use) > plen:
            use = use[-plen:]
            req.truncated = True
        toks = np.zeros(plen, np.int32)
        if self.pad_side == "left":
            toks[plen - len(use):] = use
        else:
            toks[:len(use)] = use
        return toks

    def _true_span(self, req: Request, plen: int) -> int:
        """Positions of the bucketed row that are computed: all of it when
        left-padded, the prompt only when right-padded."""
        return plen if self.pad_side == "left" else min(len(req.prompt), plen)

    def _lookup_width(self, span: int) -> int:
        """Blocks a prefix hit may cover: never the one holding the last
        prompt position, which is recomputed so the first token's logits
        exist even on a full hit, and decode writes only private blocks."""
        return (span - 1) // self.block_size

    def _hashes_for(self, req: Request, plen: int) -> List[int]:
        """The request's full-block hash chain, memoized on the request."""
        if req._hash_cache is None or req._hash_cache[0] != plen:
            req._hash_cache = (plen, cache_lib.hash_token_blocks(
                self._padded_prompt(req, plen), self.block_size))
        return req._hash_cache[1]

    def _peek_hit(self, req: Request, plen: int) -> int:
        """Reusable blocks, conservatively, for the admission budget."""
        if not self.prefix_cache:
            return 0
        hashes = self._hashes_for(req, plen)
        return self._pool.peek(hashes[:self._lookup_width(self._true_span(req, plen))])

    def _admit(self) -> None:
        # parked requests first, oldest admission first; a parked head that
        # does not fit blocks the queue too, so new arrivals never starve a
        # request that has emitted tokens
        while self._preempted:
            if not self._try_readmit():
                return
        while self.queue:
            free = [s for s in range(self.max_batch) if self.slots[s] is None]
            if not free:
                return
            # the head of the queue sets the prompt bucket; every queued
            # request of that bucket joins, in FCFS order, up to the free
            # slots and (paged) the free blocks, less the prefix hits.  A
            # head that does not fit in the pool blocks admission: strict
            # FCFS backpressure.
            plen = self._bucketed(len(self.queue[0].prompt))
            picked: List[Request] = []
            blocks_reserved = 0
            for req in self.queue:
                if len(picked) == len(free):
                    break
                if self._bucketed(len(req.prompt)) != plen:
                    continue
                if self.layout == "paged":
                    nb = (self._blocks_for(self._true_span(req, plen), req.params.max_new_tokens)
                          - self._peek_hit(req, plen))
                    if blocks_reserved + nb > self._pool.available:
                        break
                    blocks_reserved += nb
                picked.append(req)
            if not picked:
                return  # pool backpressure: wait for finishes to free blocks
            picked_ids = {id(r) for r in picked}
            self.queue = deque(r for r in self.queue if id(r) not in picked_ids)
            for req in picked:
                req.admit_seq = self._admit_seq
                self._admit_seq += 1
            slots_for = free[:len(picked)]
            if self.chunk > 0:
                self._admit_chunked(picked, slots_for, plen)
            elif self.pad_side == "right":
                self._admit_right_unchunked(picked, slots_for, plen)
            else:
                self._admit_batch(picked, slots_for, plen)

    def _admission_cache(self, n: int):
        """The cache an admission prefill of ``n`` rows fills: the live pool
        of every paged layer (shared by all slots; the prefill writes the
        prompts' K/V into their blocks), a fresh ``n``-row entry for every
        per-slot layer (contiguous K/V, sliding-window rings, recurrent
        states), so each admitted row starts from its initial values."""
        dtype = getattr(torch, self.cfg.dtype)
        return [entry if "kp" in entry else
                cache_lib.init_block_cache(self.model.cfg, blk.kind, n, self.max_len,
                                           dtype, self.device, shards=self.model.shards)
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

    def _slot_view(self, slot: int):
        """The live cache seen as one row, slot ``slot``'s: views of the
        per-slot leaves and the whole pools, so a chunk's in-place writes
        land in the live tensors."""
        return [{leaf: t if leaf in ("kp", "vp") or t.dim() == 0 else t[slot:slot + 1]
                 for leaf, t in entry.items()} for entry in self.cache]

    def _admit_batch(self, reqs: List[Request], slots_for: List[int], plen: int) -> None:
        """One prefill for ``reqs`` (all bucketed to ``plen``) into
        ``_admission_cache``, then into the slots (``_merge_admitted``), as
        the reference's merge does.  Paged: the prompts' K/V go straight
        into their pool blocks.  With the prefix cache, requests whose
        prefix is resident are admitted first through their suffix alone
        (``_admit_prefix_hit``); the rest register their full prompt
        blocks, first come first served."""
        padded = [self._padded_prompt(r, plen) for r in reqs]
        hashes: List[Optional[List[int]]] = [None] * len(reqs)
        if self.prefix_cache:
            keep: List[int] = []
            for i, (req, slot) in enumerate(zip(reqs, slots_for)):
                hashes[i] = self._hashes_for(req, plen)
                hit = self._pool.lookup(hashes[i][:self._lookup_width(plen)])
                self.prefix_lookups += 1
                if hit:
                    self._admit_prefix_hit(req, slot, plen, padded[i], hashes[i], hit)
                else:
                    keep.append(i)
            if not keep:
                return
            reqs, slots_for, padded, hashes = ([xs[i] for i in keep]
                                               for xs in (reqs, slots_for, padded, hashes))
        n = len(reqs)
        batch = {"tokens": torch.from_numpy(np.stack(padded)).to(self.device)}
        if self.nv:
            batch["vision_embeds"] = self._vision_embeds(n)
        tables_np, tables = None, None
        if self.layout == "paged":
            tables_np = np.zeros((n, self.max_blocks_per_slot), np.int32)
            for r, (req, slot) in enumerate(zip(reqs, slots_for)):
                nb = self._blocks_for(plen, req.params.max_new_tokens)
                blocks = self._pool.allocate(nb)
                tables_np[r, :nb] = blocks
                self._slot_blocks[slot] = blocks
                if self.prefix_cache:  # written by the prefill below
                    for i in range(plen // self.block_size):
                        if self._pool.register(hashes[r][i], blocks[i]):
                            self._pool.mark_ready(blocks[i])
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

    def _claim_prefix_blocks(self, req: Request, slot: int, span: int, hashes: List[int],
                             hit: List[int], nb: Optional[int] = None):
        """Commit one admission's blocks: the reused prefix blocks first
        (``lookup`` took their references), fresh ones after, in table
        order.  Full prompt blocks past the hit are registered for later
        sharers, not ready until the caller has written them.  ``nb``
        overrides the block count (a re-admission covers the prompt and
        the emitted tokens).  Returns (table row, first position to
        prefill, (end, block) pairs to mark ready as the prefill passes
        them)."""
        h = len(hit)
        if nb is None:
            nb = self._blocks_for(span, req.params.max_new_tokens)
        blocks = hit + self._pool.allocate(nb - h)
        tables_np = np.zeros(self.max_blocks_per_slot, np.int32)
        tables_np[:nb] = blocks
        self._slot_blocks[slot] = blocks
        pending = [((i + 1) * self.block_size, blocks[i])
                   for i in range(h, span // self.block_size)
                   if self._pool.register(hashes[i], blocks[i])]
        if h:
            self.prefix_hits += 1
        self.prefix_blocks_reused += h
        start = h * self.block_size
        self.prefill_tokens_skipped += start
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)
        return tables_np, start, pending

    def _admit_prefix_hit(self, req: Request, slot: int, plen: int, toks: np.ndarray,
                          hashes: List[int], hit: List[int]) -> None:
        """Whole-prompt admission of a request with resident prefix blocks:
        only its suffix is prefilled, as one chunk over the live pool."""
        tables_np, start, pending = self._claim_prefix_blocks(req, slot, plen, hashes, hit)
        self.slots[slot] = req
        cur = _PrefillCursor(req=req, tokens=toks, plen=plen, next=start, tables_np=tables_np)
        logits = self._run_chunk(slot, cur, plen - start)
        for _, blk in pending:  # the suffix is written: publish its blocks
            self._pool.mark_ready(blk)
        self._start_decoding(req, slot, plen, logits, tables_np)

    def _admit_chunked(self, reqs: List[Request], slots_for: List[int], plen: int) -> None:
        """Chunked admission: reserve each slot (and its blocks, reusing
        resident prefix blocks) and open its cursor; no prompt work yet, so
        admission never stalls the decodes in flight.  The slots' rows are
        reset by the step's one ``_flush_resets``: a chunk writes only its
        own span, and the last occupant's positions or recurrent state
        would leak into its attention and state."""
        for req, slot in zip(reqs, slots_for):
            toks = self._padded_prompt(req, plen)
            span = self._true_span(req, plen)
            tables_np, start, pending = None, 0, []
            if self.prefix_cache:
                hashes = self._hashes_for(req, plen)
                hit = self._pool.lookup(hashes[:self._lookup_width(span)])
                self.prefix_lookups += 1
                tables_np, start, pending = self._claim_prefix_blocks(req, slot, span, hashes,
                                                                      hit)
            elif self.layout == "paged":
                nb = self._blocks_for(span, req.params.max_new_tokens)
                blocks = self._pool.allocate(nb)
                tables_np = np.zeros(self.max_blocks_per_slot, np.int32)
                tables_np[:nb] = blocks
                self._slot_blocks[slot] = blocks
            self.slots[slot] = req
            self._cursors[slot] = _PrefillCursor(req=req, tokens=toks, plen=span, next=start,
                                                 tables_np=tables_np, pending_ready=pending)
            self._prefill_order.append(slot)
            if tables_np is not None:
                # the unified step's chunk reads the tables in the state; the
                # slot stays inactive, so its decode writes go to block 0
                self._state["block_tables"][slot].copy_(torch.from_numpy(tables_np))
        if self.layout == "paged":
            self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)
        self._pending_reset.extend(slots_for)

    def _admit_right_unchunked(self, reqs: List[Request], slots_for: List[int],
                               plen: int) -> None:
        """Whole-prompt admission of right-padded rows: reserve through the
        chunked path (per-request spans, prefix hits), then run each span
        at once as one chunk padded to the bucket, so the request decodes
        in this same step."""
        self._admit_chunked(reqs, slots_for, plen)
        self._flush_resets()
        for slot in slots_for:
            cur = self._cursors[slot]
            logits = self._run_chunk(slot, cur, cur.plen - cur.next, pad_to=plen)
            cur.next = cur.plen
            for _, blk in cur.pending_ready:
                self._pool.mark_ready(blk)
            self._prefill_order.remove(slot)
            self._cursors[slot] = None
            self._start_decoding(cur.req, slot, cur.plen, logits, cur.tables_np)

    # -- chunked prefill ----------------------------------------------------------
    def _advance_chunks(self) -> None:
        """Spend the step's prefill budget on the cursors, FCFS, one chunk
        dispatch each; a cursor's next chunk runs only if it fits what is
        left of the budget."""
        budget = self.chunk_budget
        while budget > 0 and self._prefill_order:
            slot = self._prefill_order[0]
            cur = self._cursors[slot]
            c = min(self.chunk, cur.plen - cur.next)
            if c > budget:
                return
            budget -= c
            logits = self._run_chunk(slot, cur, c)
            cur.next += c
            self._chunk_landed(slot, cur, logits=logits)

    def _chunk_landed(self, slot: int, cur: _PrefillCursor, *, logits=None,
                      first: Optional[int] = None) -> None:
        """After a cursor's chunk: publish the registered blocks it has
        written, so later admissions can share a prompt still being
        prefilled; after its last chunk the slot starts decoding, or a
        recomputed one resumes where it was preempted."""
        while cur.pending_ready and cur.pending_ready[0][0] <= cur.next:
            self._pool.mark_ready(cur.pending_ready.pop(0)[1])
        if cur.next == cur.plen:
            self._prefill_order.remove(slot)
            self._cursors[slot] = None
            if cur.resume_n > 0:
                self._resume_decoding(cur.req, slot, cur.plen, cur.resume_n, cur.tables_np)
            else:
                self._start_decoding(cur.req, slot, cur.plen, logits, cur.tables_np,
                                     first=first)

    def _vision_embeds(self, n: int) -> torch.Tensor:
        """The patch embeddings of ``n`` admitted prompts: zeros, as the
        reference serves a vision model."""
        return torch.zeros((n, self.nv, self.cfg.d_model), dtype=getattr(torch, self.cfg.dtype),
                           device=self.device)

    def _run_chunk(self, slot: int, cur: _PrefillCursor, c: int, pad_to: int = 0):
        """The next ``c`` tokens of one slot's prompt through
        ``model.prefill_chunk`` on the slot's view of the live cache;
        ``pad_to > c`` pads the row to that width and passes the true
        length.  A vision prefix rides with the first chunk, and later
        chunks start past it.  Returns the logits of the last valid
        position."""
        toks = cur.tokens[cur.next:cur.next + c]
        lengths = None
        if pad_to > c:
            toks = np.concatenate([toks, np.zeros(pad_to - c, np.int32)])
            lengths = torch.tensor([c], dtype=torch.int32, device=self.device)
        tables = (None if cur.tables_np is None
                  else torch.from_numpy(cur.tables_np[None]).to(self.device))
        start, vision = cur.next, None
        if self.nv:
            if start == 0:
                vision = self._vision_embeds(1)
            else:
                start += self.nv
        logits, _ = self.model.prefill_chunk(
            torch.from_numpy(toks[None]).to(self.device), self._slot_view(slot), start,
            block_tables=tables, lengths=lengths, vision_embeds=vision)
        self._dispatches += 1
        self.chunk_forwards += 1
        return logits

    def _pick_frontier(self) -> List[tuple]:
        """The cursor frontier one unified step advances: the chunks
        ``_advance_chunks`` would run, with the consecutive chunks of one
        cursor merged into one row.  Returns [(slot, cursor, tokens)]; a
        head chunk that does not fit the budget ends the scan, and no
        budget passes a cursor left unfinished."""
        budget = self.chunk_budget
        frontier: List[tuple] = []
        for slot in self._prefill_order:
            cur = self._cursors[slot]
            take = 0
            while True:
                c = min(self.chunk, cur.plen - cur.next - take)
                if c <= 0 or c > budget:
                    break
                take += c
                budget -= c
            if take:
                frontier.append((slot, cur, take))
            if cur.next + take < cur.plen:
                break
        return frontier

    def _unified_once(self, frontier: List[tuple]) -> None:
        """One unified step: upload the packed frontier (one copy), advance
        it and decode (or verify) every armed slot in one dispatch, read
        back the packed result.  Without a frontier it is the plain decode
        step.  A cursor preempted after the frontier was picked has its
        table row at the garbage block, so its chunk wrote there (and into
        per-slot rows that the next occupant resets): its advance is
        dropped."""
        if not frontier:
            self._decode_once()
            return
        buf = np.zeros(tuple(self._chunk_buf.shape), np.int32)
        for slot, cur, c in frontier:
            pack_chunk(buf, slot, cur.tokens[cur.next:cur.next + c], cur.next,
                       cur.req.params, request_key(self.seed, cur.req.uid))
        self._chunk_buf.copy_(torch.from_numpy(buf))
        if self._unified_graph is not None:
            self._unified_graph.replay()
            out = self._unified_out
            dispatch.credit(self._unified_launches)
        else:
            out = self._unified_step(self._state, self._chunk_buf, self.cache)
        self._dispatches += 1
        self.chunk_forwards += 1
        if self.spec_k:
            self.chunk_forwards += 1  # the verify window is a second chunk pass
        else:
            self.decode_forwards += 1
        out_np = out.cpu().numpy()  # the step's one host sync
        firsts = out_np[:, -1] if self.spec_k else out_np[3]
        for slot, cur, c in frontier:
            if self._cursors[slot] is not cur:
                continue
            cur.next += c
            self._chunk_landed(slot, cur, first=int(firsts[slot]))
        self._process_out(out_np[:, :-1] if self.spec_k else out_np[:3])

    def _start_decoding(self, req: Request, slot: int, plen: int, logits,
                        table_row: Optional[np.ndarray], first: Optional[int] = None) -> None:
        """Take the first token (draw 0 of the request's stream: sampled
        here from ``logits``, or ``first`` as the unified step drew it)
        and arm the slot's device row; its decode draws continue from
        draw 1."""
        key = request_key(self.seed, req.uid)
        if first is None:
            first = int(sample(logits, req.params, key, index=0)[0])
        req.first_token_time = time.perf_counter()
        req.output_tokens.append(first)
        self._count_token(req)
        self._notify_stream(req, [first])

        position = self.nv + plen  # the vision prefix comes before the prompt
        done = (req.params.max_new_tokens <= 1
                or (req.params.eos_token >= 0 and first == req.params.eos_token)
                or position >= self.max_len - 1)
        write_slot(self._state, slot, token=first, position=position,
                   remaining=req.params.max_new_tokens - 1, params=req.params,
                   active=not done, key=key, count=1)
        self._next_pos[slot] = position
        if table_row is not None:
            self._state["block_tables"][slot].copy_(torch.from_numpy(table_row))
        if done:
            self._finish(slot)

    def _resume_decoding(self, req: Request, slot: int, position: int, n: int,
                         table_row: Optional[np.ndarray]) -> None:
        """Re-arm a recomputed slot where the preemption cut it off: its
        next input is the last token it emitted (whose K/V the next step
        writes, as any decode write), and its next draw is draw ``n`` of
        its stream, the index it would have had without the preemption, so
        the resumed stream equals an unpreempted one.  Nothing is sampled
        here.  Counted as one dispatch, as the reference counts the launch
        that restores its random chain."""
        remaining = req.params.max_new_tokens - n
        # a parked request always has budget and room left; if not, finish
        active = remaining > 0 and position < self.max_len - 1
        write_slot(self._state, slot, token=req.output_tokens[-1], position=position,
                   remaining=remaining, params=req.params, active=active,
                   key=request_key(self.seed, req.uid), count=n)
        self._dispatches += 1
        self._next_pos[slot] = position
        if table_row is not None:
            self._state["block_tables"][slot].copy_(torch.from_numpy(table_row))
        if not active:
            self._finish(slot)

    # -- decode -------------------------------------------------------------------
    def _decode_once(self) -> None:
        # a prefilling slot is not armed: its first token comes with its
        # last chunk
        if not any(req is not None and cur is None
                   for req, cur in zip(self.slots, self._cursors)):
            return
        if self._graph is not None:
            self._graph.replay()
            out = self._graph_out
            dispatch.credit(self._graph_launches)
        else:
            out = self._step(self._state, self.cache)
        self._dispatches += 1
        if self.spec_k:
            self.chunk_forwards += 1  # the verify window is a chunk pass
        else:
            self.decode_forwards += 1
        self._process_out(out.cpu().numpy())  # the step's one host sync

    def _process_out(self, out_np: np.ndarray) -> None:
        """One step's packed output: the (3, B) decode output or the
        (B, 2 (k + 1) + 1) verify output."""
        if self.spec_k:
            self._process_spec_out(out_np)
        else:
            self._process_decode_out(out_np)

    def _process_decode_out(self, out_np: np.ndarray) -> None:
        tokens, done, emitted = out_np[0], out_np[1], out_np[2]
        any_emit = False
        for slot in np.nonzero(emitted)[0]:
            req = self.slots[slot]
            if req is None:
                continue
            any_emit = True
            self._decode_tokens += 1
            self._next_pos[slot] += 1  # the step wrote its K/V there
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

    # -- speculative decoding -------------------------------------------------------
    def _arm_drafts(self) -> None:
        """Draft each decoding slot's next tokens from its prompt and
        emitted tokens (ring included), on the host, and upload every
        draft and length as one (B, k + 1) copy into the step's buffer.
        A draft is cut so that the window, which writes K/V at the slot's
        next position and one past it per draft token and may emit one
        token more than the draft, stays inside the budget and the cache.
        The buffer is rebuilt from zero every step, so a slot re-armed,
        preempted or finished never replays a stale draft."""
        K = self.spec_k
        drafts = np.zeros((self.max_batch, K + 1), np.int32)
        self._draft_len_host[:] = 0
        for slot in range(self.max_batch):
            req = self.slots[slot]
            if req is None or self._cursors[slot] is not None:
                continue
            n_ring = int(self._ring_n[slot])
            emitted = len(req.output_tokens) + n_ring
            p = int(self._next_pos[slot])
            cap = min(K, req.params.max_new_tokens - emitted - 1, self.max_len - 2 - p)
            if cap <= 0:
                continue
            hist = ([int(t) for t in req.prompt] + req.output_tokens
                    + [int(t) for t in self._ring[slot, :n_ring]])
            d = prompt_lookup_draft(hist, cap)
            if not d:
                continue
            drafts[slot, :len(d)] = d
            drafts[slot, K] = len(d)
            self._draft_len_host[slot] = len(d)
            self._drafted_tokens += len(d)
        self._state["drafts"].copy_(torch.from_numpy(drafts))

    def _process_spec_out(self, out_np: np.ndarray) -> None:
        """One verify step's (B, 2 (k + 1) + 1) output: per slot, the
        emission mask is a prefix of the window, so its first n token
        columns are the slot's emitted tokens in stream order."""
        K1 = self.spec_k + 1
        tokens, emit, done = out_np[:, :K1], out_np[:, K1:2 * K1], out_np[:, 2 * K1]
        any_emit = False
        for slot in range(self.max_batch):
            req = self.slots[slot]
            n = int(emit[slot].sum())
            if req is None or n == 0:
                continue
            any_emit = True
            self._spec_verifies += 1
            self._accepted_tokens += n - 1
            self._decode_tokens += n
            for i in range(n):
                self._next_pos[slot] += 1  # the step wrote its K/V there
                rn = int(self._ring_n[slot])
                self._ring[slot, rn] = tokens[slot, i]
                self._ring_n[slot] = rn + 1
                if rn + 1 == _RING:
                    self._flush_ring(slot)
                self._count_token(req)
            self._notify_stream(req, [int(t) for t in tokens[slot, :n]])
            if done[slot]:
                self._finish(slot)
            elif self.preemption != "off":
                self._rollback_spec_blocks(slot)
        if any_emit:
            self._decode_dispatches += 1

    def _rollback_spec_blocks(self, slot: int) -> None:
        """Free the grown blocks a rejected draft suffix no longer needs
        (under preemption only: otherwise the window never grows past the
        admission's blocks), their table entries back at the garbage block.
        The rejected K/V is never rolled back: the next window writes the
        positions it reads again first, positions past it lie past every
        query, and a freed block handed to another request holds only
        positions that request has not reached."""
        keep = int(self._next_pos[slot]) // self.block_size + 1
        blocks = self._slot_blocks[slot]
        if len(blocks) <= keep:
            return
        extra = blocks[keep:]
        self._slot_blocks[slot] = blocks[:keep]
        self._pool.free(extra)
        self._state["block_tables"][slot, keep:keep + len(extra)] = cache_lib.GARBAGE_BLOCK

    # -- preemption with recompute ------------------------------------------------
    def _grow_decode_blocks(self) -> None:
        """Lazy growth (``preemption="recompute"``): before the step runs,
        each decoding slot whose next writes (the verify window's too)
        reach past its blocks gets more.  When the pool is dry (free stack
        and evictable LRU empty) the newest admitted request in flight,
        possibly the growing one, is preempted and its blocks serve the
        growth.  The head of line is never a victim, so it always
        progresses and the engine drains."""
        if self.layout != "paged" or self.preemption == "off":
            return
        bs = self.block_size
        for slot in range(self.max_batch):
            req = self.slots[slot]
            if req is None or self._cursors[slot] is not None:
                continue
            need = (int(self._next_pos[slot]) + int(self._draft_len_host[slot])) // bs + 1
            while len(self._slot_blocks[slot]) < need:
                if self.slots[slot] is not req:
                    break  # the growing slot itself was preempted
                if self._pool.available == 0:
                    victim = self._pick_victim()
                    assert victim is not None, ("pool dry with no preemptible victim: the "
                                                "pool is smaller than one worst-case request")
                    self._preempt(victim)
                    continue
                blk = self._pool.allocate(1)[0]
                self._slot_blocks[slot].append(blk)
                self._state["block_tables"][slot, len(self._slot_blocks[slot]) - 1] = blk
            self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)

    def _pick_victim(self) -> Optional[int]:
        """The newest admitted request in flight, never the oldest (the
        head of line)."""
        live = [s for s in range(self.max_batch) if self.slots[s] is not None]
        if len(live) < 2:
            return None
        head = min(live, key=lambda s: self.slots[s].admit_seq)
        return max((s for s in live if s != head), key=lambda s: self.slots[s].admit_seq)

    def _preempt(self, slot: int) -> None:
        """Park one request in flight: flush its emitted tokens, drop a
        cursor it was prefilling, retire its device row, free its blocks
        (a shared prefix block only loses a reference) and queue it for
        re-admission."""
        req = self.slots[slot]
        assert req is not None
        assert any(r is not None and r.admit_seq < req.admit_seq for r in self.slots), \
            "head-of-line request preempted"
        self._flush_ring(slot)
        if self._cursors[slot] is not None:  # parked mid-prefill
            self._cursors[slot] = None
            self._prefill_order.remove(slot)
        self.slots[slot] = None
        invalidate_slot(self._state, slot, garbage_block=cache_lib.GARBAGE_BLOCK)
        if self._slot_blocks[slot]:
            self._pool.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
        self.preemptions += 1
        req.preemptions += 1
        self._preempted.append(req)
        self._preempted.sort(key=lambda r: r.admit_seq)

    def _try_readmit(self) -> bool:
        """Re-admit the oldest parked request if a slot and its blocks are
        free: its prompt and every token it emitted but the last are
        recomputed through the chunk path (cursors, or one chunk at once
        without chunked prefill), reusing resident prefix blocks as any
        admission does; then the slot resumes where it stopped."""
        req = self._preempted[0]
        free = [s for s in range(self.max_batch) if self.slots[s] is None]
        if not free:
            return False
        plen = self._bucketed(len(req.prompt))
        span = self._true_span(req, plen)
        n = len(req.output_tokens)
        total = span + max(n - 1, 0)  # positions to recompute: 0 .. total - 1
        nb = min(cache_lib.blocks_per_slot(min(total + 1, self.max_len), self.block_size),
                 self.max_blocks_per_slot)
        if nb - self._peek_hit(req, plen) > self._pool.available:
            return False
        self._preempted.pop(0)
        slot = free[0]
        toks = self._padded_prompt(req, plen)[:span]
        if n > 1:
            toks = np.concatenate([toks, np.asarray(req.output_tokens[:n - 1], np.int32)])
        start, pending = 0, []
        if self.prefix_cache:
            hashes = self._hashes_for(req, plen)
            hit = self._pool.lookup(hashes[:self._lookup_width(span)])
            self.prefix_lookups += 1
            tables_np, start, pending = self._claim_prefix_blocks(req, slot, span, hashes, hit,
                                                                  nb=nb)
        else:
            blocks = self._pool.allocate(nb)
            tables_np = np.zeros(self.max_blocks_per_slot, np.int32)
            tables_np[:nb] = blocks
            self._slot_blocks[slot] = blocks
            self.peak_blocks_in_use = max(self.peak_blocks_in_use, self.blocks_in_use)
        self.slots[slot] = req
        self.recompute_tokens += total - start
        # another request may have held the row since: reset it before the
        # replay (in the step's one batched reset)
        self._pending_reset.append(slot)
        cur = _PrefillCursor(req=req, tokens=toks, plen=total, next=start,
                             tables_np=tables_np, pending_ready=pending, resume_n=n)
        if self.chunk > 0:
            self._cursors[slot] = cur
            self._prefill_order.append(slot)
            self._state["block_tables"][slot].copy_(torch.from_numpy(tables_np))
        else:
            self._flush_resets()  # the replay runs now
            logits = self._run_chunk(slot, cur, total - start)
            for _, blk in pending:
                self._pool.mark_ready(blk)
            if n > 0:
                self._resume_decoding(req, slot, total, n, tables_np)
            else:
                self._start_decoding(req, slot, total, logits, tables_np)
        return True

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
        if self._cursors[slot] is not None:  # abandoned mid-prefill
            self._cursors[slot] = None
            self._prefill_order.remove(slot)
        self._flush_ring(slot)
        req.finish_time = time.perf_counter()
        self.finished.append(req)
        self.slots[slot] = None
        invalidate_slot(self._state, slot, garbage_block=cache_lib.GARBAGE_BLOCK)
        if self._slot_blocks[slot]:
            # shared blocks lose a reference (the last reader parks them on
            # the evictable LRU); private ones go back on the free stack
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

    def _local_ledger(self, peak: bool) -> Dict:
        """This rank's attention KV bytes, from its own cache leaves (the
        scope of ``kv_bytes_in_use``: paged, each pool leaf's bytes per
        block times the blocks in use or their peak; contiguous, the
        ``k``/``v`` stripes whole), and its pool's block accounting."""
        blocks = self.peak_blocks_in_use if peak else self.blocks_in_use
        nbytes = 0
        for entry in self.cache:
            for leaf, t in entry.items():
                if self.layout == "paged" and leaf in ("kp", "vp"):
                    nbytes += t.numel() // self.num_blocks * blocks * t.element_size()
                elif self.layout != "paged" and leaf in ("k", "v"):
                    nbytes += t.numel() * t.element_size()
        return {"kv_bytes": nbytes, "pool": self._pool.shard_accounting(1)[0]}

    def _ledgers(self, peak: bool = False) -> List[Dict]:
        """Every rank's ``_local_ledger``, in rank order (on rank 0)."""
        if self.mesh is None:
            return [self._local_ledger(peak)]
        if not self.leader:
            raise RuntimeError("rank 0 gathers the per-device ledgers")
        self._command("ledger", peak)
        return self.mesh.gather_objects(self._local_ledger(peak))

    def kv_bytes_by_device(self, peak: bool = False) -> List[int]:
        """Attention KV bytes resident on each device, from each rank's own
        cache leaves (the reference's ``kv_bytes_by_device``): with the KV
        heads or the contiguous cache's slots split over the ranks they
        sum to ``kv_bytes_in_use``; a replicated pool or cache counts in
        full on every rank."""
        if self.mesh is None:
            return [self.kv_bytes_in_use(peak)]
        return [ledger["kv_bytes"] for ledger in self._ledgers(peak)]

    def pool_accounting_by_device(self) -> List[Dict[str, int]]:
        """Each device's block accounting (``BlockPool.shard_accounting``),
        read from each rank's own pool: the host-managed tables are the
        same on every rank, so each holds the same free / in-use /
        evictable partition of its KV shard."""
        if self.mesh is None:
            return self._pool.shard_accounting(1)
        return [ledger["pool"] for ledger in self._ledgers()]

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
            for s in self.slots + self._preempted:
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
        if self.mesh is not None:
            ledgers = self._ledgers(peak=True)
            summary["tp_devices"] = self.n_devices
            summary["kv_bytes_peak_per_device"] = [ledger["kv_bytes"] for ledger in ledgers]
            if self.layout == "paged":
                summary["pool_blocks_in_use_per_device"] = [ledger["pool"]["in_use"]
                                                            for ledger in ledgers]
            if self._bcast_s:
                summary["tp_broadcast_us_p50"] = _percentile(self._bcast_s, 50) * 1e6
                summary["tp_broadcast_us_p95"] = _percentile(self._bcast_s, 95) * 1e6
        if self._steps_done:
            wall = max(self._steps_t1 - (self._steps_t0 or 0.0), 1e-9)
            summary["steps_per_sec"] = self._steps_done / wall
            summary["dispatches_per_step_p50"] = _percentile(self._dispatch_samples, 50)
            summary["dispatches_per_step_p95"] = _percentile(self._dispatch_samples, 95)
        if self.spec_k:
            summary["drafted_tokens"] = self._drafted_tokens
            summary["accepted_tokens"] = self._accepted_tokens
            summary["spec_accept_rate"] = self._accepted_tokens / max(self._drafted_tokens, 1)
        if self.layout == "paged":
            summary["preemptions"] = self.preemptions
            summary["recompute_tokens"] = self.recompute_tokens
            summary["pool_occupancy_p50"] = _percentile(self._occ_samples, 50)
            summary["pool_occupancy_p95"] = _percentile(self._occ_samples, 95)
        if self.prefix_cache:
            summary["prefix_lookups"] = self.prefix_lookups
            summary["prefix_hit_rate"] = self.prefix_hits / max(self.prefix_lookups, 1)
            summary["prefix_blocks_reused"] = self.prefix_blocks_reused
            summary["prefill_tokens_skipped"] = self.prefill_tokens_skipped
            # per registered hash: [hits, misses, evictions] at block grain
            stats = self._pool.prefix_stats.values()
            summary["prefix_block_hits"] = sum(st[0] for st in stats)
            summary["prefix_block_misses"] = sum(st[1] for st in stats)
            summary["prefix_block_evictions"] = sum(st[2] for st in stats)
            summary["prefix_hashes_tracked"] = len(self._pool.prefix_stats)
            summary["prefix_blocks_resident"] = len(self._pool.ready)
        if self.monitor is not None:
            total_j = sum(r.joules for r in self.finished)
            summary["joules_total"] = total_j
            summary["joules_per_request"] = total_j / max(len(self.finished), 1)
            summary["joules_per_token"] = total_j / max(out_tokens, 1)
            res = self.monitor.result()
            summary["power_samples_per_sec"] = res.samples_per_sec
            summary["power_reads_dropped"] = res.dropped_reads
            # a DeviceMonitorGroup's per-device ledgers over its window: they
            # sum to result().joules; a device that dropped every read gives
            # 0 J and its drop count
            by_device = getattr(self.monitor, "result_by_device", None)
            if callable(by_device):
                devices = by_device()
                summary["joules_per_device"] = [r.joules for r in devices]
                summary["power_samples_per_sec_per_device"] = [r.samples_per_sec
                                                                for r in devices]
                summary["power_reads_dropped_per_device"] = [r.dropped_reads for r in devices]
        return summary
