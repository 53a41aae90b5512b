"""Work run on every rank of a tensor-parallel group, and the same work
without one, for comparing the two: the rank functions ``spawn_tp`` calls
(``launch.mesh``), kept in the package so a spawned rank can import them.

``run_plan(mesh, plan, device)`` builds each model of ``plan`` (a list of
``(Weights, [job, ...])``) as the rank's shard, or whole with ``mesh``
None, runs its jobs in order and returns their results, one list per
model.  The jobs:

* ``Serve``: a ``ServingEngine`` over the model; rank 0 submits the
  arrivals and runs it, the other ranks follow.  Every rank returns its
  streams; rank 0 also the summary, the ledgers and the dispatches per
  step.
* ``Logits``: a prompt prefilled, whole or in chunks (after a vision
  model's patch embeddings), then decode steps on given tokens; the fp32
  logits of each.
* ``CacheLeaves``: a prompt prefilled, some rows reset; the rank's
  cache leaves.
* ``Params``: the rank's parameters.
* ``Launches``: the rank's kernel launch counts.
* ``Collectives``: the mesh's collectives, eager and from a CUDA graph.
* ``Refusal``: what building the shard, or an engine over it, raises.

A MoE model's ``Serve`` and ``Logits`` can record each MoE call's routing
(``record``) and take given routes in place of their own top-k
(``routes``, ``models.moe.routing``): bf16 rounding flips top-k sets, so
a check holds a tensor-parallel run to tp = 1's routes where it compares
numbers, not routing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig


def _routing(routes, record: bool):
    """``moe.routing`` over ``routes`` (numpy (T, k) ids per MoE call, or
    None) and a fresh log where ``record``; returns (context, log)."""
    log = [] if record else None
    forced = None if routes is None else [torch.from_numpy(np.asarray(r)) for r in routes]
    return moe_lib.routing(log, forced), log


def _routes_out(log) -> Dict[str, List[np.ndarray]]:
    """A routing log as numpy: each call's expert ids and kept mask."""
    return {"ids": [i.cpu().numpy() for i, _ in log],
            "kept": [k.cpu().numpy() for _, k in log]}


@dataclasses.dataclass
class Weights:
    """A model's weights: drawn from ``seed`` (``models.model.init``, or
    ``sharding.partition.shard_model`` for a rank), or the reference's
    parameter tree ``tree`` (``bridge.params_from_jax``); the input table
    (the rank's rows of it) then scaled by ``table_scale`` (a tied random
    table of N(0, 1) rows can drive every logit into a softcap)."""
    cfg: ModelConfig
    seed: int = 0
    tree: Optional[Mapping] = None
    table_scale: float = 1.0

    def build(self, mesh, device):
        from repro_torch import bridge
        from repro_torch.models import model as model_lib
        from repro_torch.sharding.partition import shard_model

        if self.tree is not None:
            model = bridge.params_from_jax(self.cfg, self.tree, device=device, mesh=mesh)
        elif mesh is None:
            gen = torch.Generator(device=device).manual_seed(self.seed)
            model = model_lib.init(self.cfg, gen, device)
        else:
            model = shard_model(self.cfg, mesh, self.seed)
        if self.table_scale != 1.0:
            with torch.no_grad():
                model.embed.table.mul_(self.table_scale)
        return model


@dataclasses.dataclass
class Serve:
    """``arrivals`` ((prompt, SamplingParams) pairs, submitted at once)
    served by an engine of ``engine`` keyword arguments; a MoE model's
    routing recorded (``record``: ``routes`` in the result) or imposed
    (``routes``, the recorded ``ids`` of a run of the same schedule; eager
    steps only)."""
    name: str
    engine: Dict[str, Any]
    arrivals: List[Tuple[np.ndarray, Any]]
    routes: Optional[List[np.ndarray]] = None
    record: bool = False

    def run(self, model, mesh, device):
        from repro_torch.serving.engine import ServingEngine

        if (self.routes is not None and self.engine.get("cuda_graph", True)
                and torch.device(device).type == "cuda"):
            raise ValueError("forced routes are read from the host: serve them with "
                             "cuda_graph=False")
        eng = ServingEngine(model, device=device, mesh=mesh, **self.engine)
        out: Dict[str, Any] = {}
        ctx, log = _routing(self.routes, self.record)
        t0 = time.perf_counter()
        if eng.leader:
            for prompt, params in self.arrivals:
                eng.submit(prompt, params)
            with ctx:
                eng.run()
            out.update(
                wall_s=time.perf_counter() - t0, summary=eng.latency_summary(),
                kv_bytes_by_device=eng.kv_bytes_by_device(peak=True),
                kv_bytes_peak=eng.kv_bytes_in_use(peak=True),
                kv_bytes_worst_case=eng.kv_bytes_worst_case,
                pool_accounting_by_device=eng.pool_accounting_by_device(),
                dispatch_samples=list(eng._dispatch_samples),
                broadcast_s=list(eng._bcast_s), preemptions=eng.preemptions)
            eng.close()
        else:
            with ctx:
                eng.follow()
        out["streams"] = {r.uid: list(r.output_tokens) for r in eng.finished}
        out["pool_accounting"] = eng._pool.shard_accounting(1)[0]
        if self.record:
            out["routes"] = _routes_out(log)
        return out


@dataclasses.dataclass
class Logits:
    """``tokens`` (B, S) prefilled (in chunks of ``chunk`` with per-row
    starts and lengths, as the unified step passes them; 0: whole), then
    one decode step on each row of ``steps`` (n, B), or with ``steps``
    None ``greedy`` steps on each step's argmax; returns the fp32 logits
    (n + 1, B, vocab) as numpy.  ``cache`` holds ``init_cache``'s layout
    arguments; a paged cache reads ``tables`` (B, blocks).  A vision
    model takes ``vision`` (B, nv, d) patch embeddings before the tokens
    (with the first chunk; the tokens and decode steps after them).  A
    MoE model takes ``routes`` (each call's (T, k) expert ids) in place of
    its own top-k; with ``record`` the result is a dict of the ``logits``
    and each call's expert ``ids`` and ``kept`` mask."""
    tokens: np.ndarray
    steps: Optional[np.ndarray]
    max_len: int
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tables: Optional[np.ndarray] = None
    chunk: int = 0
    greedy: int = 0
    vision: Optional[np.ndarray] = None
    routes: Optional[List[np.ndarray]] = None
    record: bool = False

    def run(self, model, mesh, device):
        ctx, log = _routing(self.routes, self.record)
        with ctx:
            logits = self._logits(model, device)
        if not self.record:
            return logits
        return {"logits": logits, **_routes_out(log)}

    def _logits(self, model, device):
        tokens = torch.from_numpy(self.tokens).to(device)
        bt = None if self.tables is None else torch.from_numpy(self.tables).to(device)
        vision = None if self.vision is None else torch.from_numpy(self.vision).to(device)
        nv = 0 if vision is None else vision.shape[1]
        B, S = tokens.shape
        cache = model.init_cache(B, self.max_len, **self.cache)
        if not self.chunk:
            batch = {"tokens": tokens}
            if vision is not None:
                batch["vision_embeds"] = vision
            logits = model.prefill(batch, cache, block_tables=bt)[0]
        else:
            for i in range(0, S, self.chunk):
                c = min(self.chunk, S - i)
                full = lambda v: torch.full((B,), v, dtype=torch.int32, device=device)  # noqa: E731
                if vision is not None and i == 0:  # the patches ride with the first chunk
                    logits, _ = model.prefill_chunk(tokens[:, :c], cache, 0, block_tables=bt,
                                                    vision_embeds=vision)
                else:
                    logits, _ = model.prefill_chunk(tokens[:, i:i + c], cache, full(nv + i),
                                                    block_tables=bt, lengths=full(c))
        out = [logits]
        n = self.greedy if self.steps is None else len(self.steps)
        for i in range(n):
            if self.steps is None:
                tok = logits.argmax(-1, keepdim=True)
            else:
                tok = torch.from_numpy(np.asarray(self.steps[i])).to(device)[:, None]
            logits, cache = model.decode_step(tok, nv + S + i, cache, block_tables=bt)
            out.append(logits)
        return torch.stack(out).float().cpu().numpy()


@dataclasses.dataclass
class CacheLeaves:
    """``tokens`` (B, S) prefilled whole into a fresh cache of ``cache``
    layout arguments (a paged one through ``tables``), then the rows
    ``reset`` of every per-slot leaf returned to their initial values
    (``cache.reset_rows``); the rank's cache leaves as numpy (bf16 as
    fp32), one dict per layer."""
    tokens: np.ndarray
    max_len: int
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tables: Optional[np.ndarray] = None
    reset: Tuple[int, ...] = ()

    def run(self, model, mesh, device):
        from repro_torch.models import cache as cache_lib

        tokens = torch.from_numpy(self.tokens).to(device)
        bt = None if self.tables is None else torch.from_numpy(self.tables).to(device)
        cache = model.init_cache(tokens.shape[0], self.max_len, **self.cache)
        model.prefill({"tokens": tokens}, cache, block_tables=bt)
        if self.reset:
            cache_lib.reset_rows(cache, torch.tensor(self.reset, device=device))
        return [{leaf: (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
                 for leaf, t in entry.items()} for entry in cache]


@dataclasses.dataclass
class Params:
    """The rank's parameters, by name, as numpy."""

    def run(self, model, mesh, device):
        return {name: p.detach().float().cpu().numpy() for name, p in model.named_parameters()}


@dataclasses.dataclass
class Launches:
    """The rank's kernel launch counts since the last ``Launches`` job
    (each count read, then set to 0)."""

    def run(self, model, mesh, device):
        from repro_torch.kernels import dispatch

        counts = {name: k.launches for name, k in dispatch.KERNELS.items()}
        for k in dispatch.KERNELS.values():
            k.launches = 0
        return counts


@dataclasses.dataclass
class Collectives:
    """The mesh's ``all_reduce`` and ``gather_last`` on rank-dependent
    inputs, eagerly and, where the mesh is capturable (NCCL), replayed
    from a CUDA graph after the inputs changed in place; the largest
    difference from the exact sums and rows of each (0.0 expected)."""

    def run(self, model, mesh, device):
        from repro_torch.kernels import dispatch

        x = torch.arange(6 * 10, dtype=torch.float32, device=device).reshape(6, 10)

        def want(shift):
            base = x + shift
            total = sum(base + r for r in range(mesh.size))
            rows = torch.cat([base + r for r in range(mesh.size)], dim=-1)
            return total, rows

        def diffs(got, shift):
            return [float((g - w).abs().max()) for g, w in zip(got, want(shift))]

        static = x + mesh.rank
        out = {"eager": diffs((mesh.all_reduce(static.clone()), mesh.gather_last(static)), 0)}
        if mesh.capturable:
            mesh.warm()
            graph, got, _ = dispatch.capture_graph(
                lambda: (mesh.all_reduce(static.clone()), mesh.gather_last(static)), device)
            static.add_(1.0)
            graph.replay()
            torch.cuda.synchronize(device)
            out["replayed"] = diffs(got, 1.0)
        return out


@dataclasses.dataclass
class Refusal:
    """The exception (type name, message) that an engine of ``engine``
    keyword arguments over the model raises; None if it raises none."""
    engine: Dict[str, Any]

    def run(self, model, mesh, device):
        from repro_torch.serving.engine import ServingEngine

        try:
            ServingEngine(model, mesh=mesh, **self.engine)
        except (TypeError, ValueError, RuntimeError) as exc:
            return type(exc).__name__, str(exc)
        return None


def run_plan(mesh, plan: List[Tuple[Weights, List[Any]]], device="cpu") -> List[List[Any]]:
    """Each model of ``plan`` built (the rank's shard, or whole without a
    mesh) and its jobs run in order; a model that cannot be built gives
    its exception (type name, message) in place of its results."""
    device = mesh.device if mesh is not None else torch.device(device)
    results = []
    for weights, jobs in plan:
        try:
            model = weights.build(mesh, device)
        except ValueError as exc:
            results.append((type(exc).__name__, str(exc)))
            continue
        results.append([job.run(model, mesh, device) for job in jobs])
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results
