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

``train_plan(mesh, jobs)`` runs ``Train`` jobs, each on a
``("data", "model")`` mesh of its own shape over the same ranks (or
whole, with ``mesh`` None): training steps from given or drawn weights,
with checkpoints written and restored; the training driver
(``DriverTrain``, with each step's collectives counted on request); and
``MeshLogits``, a prefill and decode steps on such a mesh, the rank's
collectives counted.

A MoE model's ``Serve`` and ``Logits`` can record each MoE call's routing
(``record``) and take given routes in place of their own top-k
(``routes``, ``models.moe.routing``): bf16 rounding flips top-k sets, so
a check holds a tensor-parallel run to tp = 1's routes where it compares
numbers, not routing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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


@dataclasses.dataclass
class Train:
    """``len(batches)`` train steps of ``cfg`` (each batch the global one,
    numpy; every rank is given it) on a ``("data", "model")`` mesh of
    ``shape`` made from the plan's ranks (or on one device where the plan
    runs without a mesh), from ``params`` (the port's names -> full
    arrays) or the weights drawn from ``seed``; AdamW with a warm-up
    cosine schedule of ``lr``, ``warmup``, ``total``.  ``ckpt_dir``: with
    ``resume`` the latest checkpoint there is restored first (the steps
    then take the batches from its step on), and with ``save_at`` > 0 one
    is written after that many steps.  Returns each step's ``loss`` and
    ``grad_norm``, ``accuracy`` and ``tokens``, the rank's parameter and
    moment ``shapes``; on rank 0 the gathered gradients of the first step
    run (``grads``), the gathered parameters just restored
    (``restored``), and the final parameters and moments (``final``), each
    by name as numpy (bf16 as fp32)."""
    cfg: ModelConfig
    batches: List[Dict[str, np.ndarray]]
    shape: Tuple[int, int] = (1, 1)
    params: Optional[Dict[str, np.ndarray]] = None
    seed: int = 0
    lr: float = 3e-3
    warmup: int = 4
    total: int = 12
    microbatches: int = 1
    remat: bool = False
    ckpt_dir: str = ""
    resume: bool = False
    save_at: int = 0
    routes: bool = False    # record each MoE call's routing on the first step run
    pods: int = 1           # the data axis split into pods (``launch.mesh.make_mesh``)

    def run(self, mesh, device):
        from repro_torch.models import model as model_lib
        from repro_torch.sharding import partition
        from repro_torch.training import checkpoint as ckpt_lib
        from repro_torch.training import optimizer as opt_lib
        from repro_torch.training import step as step_lib

        cfg = self.cfg
        opt = opt_lib.AdamW(schedule=opt_lib.warmup_cosine_schedule(
            self.lr, self.warmup, self.total))
        if self.params is not None:
            model = (partition.shard_params(cfg, self.params, mesh) if mesh is not None
                     else _whole_model(cfg, self.params, device))
        elif mesh is not None:
            model = partition.shard_model(cfg, mesh, self.seed)
        else:
            model = model_lib.init(cfg, torch.Generator(device=device).manual_seed(self.seed),
                                   device)
        state = step_lib.train_state(model, opt)
        placement = model.placement
        step = step_lib.make_train_step(cfg, opt, remat=self.remat,
                                        microbatches=self.microbatches, mesh=mesh)
        out: Dict[str, Any] = {"shapes": {n: tuple(p.shape) for n, p in state.params().items()},
                               "moment_shapes": {n: tuple(t.shape)
                                                 for n, t in state.opt.mu.items()}}
        lead = mesh is None or mesh.rank == 0

        def gathered(tensors):
            if mesh is None:
                return {n: t.detach().float().cpu().numpy() for n, t in tensors.items()}
            full = partition.gather_params(tensors, placement)
            return {n: t.float().numpy() for n, t in full.items()} if lead else None

        def tree():
            return {"params": state.params(), "opt_mu": state.opt.mu, "opt_nu": state.opt.nu}

        first = 0
        if self.resume:
            restored, manifest = ckpt_lib.restore(self.ckpt_dir, tree(), device=device,
                                                  placement=placement)
            with torch.no_grad():
                for part in ("params", "opt_mu", "opt_nu"):
                    for k, t in tree()[part].items():
                        t.copy_(restored[part][k])
            first = state.opt.count = state.step = manifest["step"]
            out["restored"] = gathered(state.params())
        metrics = {k: [] for k in ("loss", "grad_norm", "accuracy", "tokens")}
        for i, batch in enumerate(self.batches[first:], start=first):
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            if i == first:  # the first step's gradients before clipping
                _, grads = step_lib.grads_of(step_lib.make_loss_fn(cfg, remat=self.remat),
                                             model, batch, mesh, self.microbatches)
                out["grads"] = gathered(grads)
                del grads
            ctx, log = _routing(None, self.routes and i == first)
            with ctx:
                m = step(state, batch)
            if log is not None:
                out["routes"] = _routes_out(log)
            for k in metrics:
                metrics[k].append(float(m[k]))
            if self.save_at and i + 1 == self.save_at:
                ckpt_lib.save(self.ckpt_dir, i + 1, tree(), placement=placement,
                              metadata={"data_offset": i + 1})
        out.update(metrics)
        out["final"] = {"params": gathered(state.params()), "mu": gathered(state.opt.mu),
                        "nu": gathered(state.opt.nu)}
        return out


@dataclasses.dataclass
class CollectiveGrads:
    """``sharding.collectives`` under autograd on a mesh of ``shape``: a
    small network split over the model axis (``copy`` into column-parallel
    products, ``reduce`` of row-parallel partials, ``gather`` of a split
    activation) and over the data axis (``fsdp_gather`` of a weight, each
    data rank its own rows, summed or whole), run on the rank's slices of
    inputs drawn from ``seed`` on every rank alike.  Returns, for each
    output and gradient, the largest difference from the same function
    run whole by autograd on one rank (its gradients sliced as the rank
    holds them)."""
    shape: Tuple[int, int] = (1, 1)
    seed: int = 0

    def run(self, mesh, device):
        from repro_torch.sharding import collectives as col

        data, model = mesh.data, mesh.model
        gen = torch.Generator().manual_seed(self.seed)
        B, d, h = 4 * data.size, 6, 4 * model.size
        x, w1, w2, w3 = (torch.randn(*s, generator=gen).to(device)
                         for s in ((B, d), (d, h), (h, d), (d, d)))

        def net(x, w1, w2, w3, split):
            """(reduce(copy(x) @ w1_r -> tanh -> @ w2_r), gather(copy(x) @ w1_r))."""
            if split:
                x = col.copy(x, model)
            a = torch.tanh(x @ w1)
            y = a @ w2
            if split:
                return col.reduce(y, model), col.gather(a, -1, model)
            return y, a

        def loss_of(y, a, w3):
            return ((y @ w3).sin().sum() + a.cos().sum()) / B

        # whole, on every rank alike
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2, w3)]
        y, a = net(*leaves[:3], leaves[3], split=False)
        whole_loss = loss_of(y, a, leaves[3])
        whole = torch.autograd.grad(whole_loss, leaves)

        # split: rows of x over data, w1's columns and w2's rows over model,
        # w3 data-sharded by rows and gathered (its gradient summed back)
        out = {}
        for summed in (True, False):
            rows = B // data.size
            xr = x[data.rank * rows:(data.rank + 1) * rows] if summed else x
            cols = h // model.size
            parts = [xr.clone(), w1[:, model.rank * cols:(model.rank + 1) * cols].clone(),
                     w2[model.rank * cols:(model.rank + 1) * cols].clone(),
                     w3[data.rank * (d // data.size):(data.rank + 1) * (d // data.size)].clone()
                     if d % data.size == 0 else w3.clone()]
            parts = [t.requires_grad_(True) for t in parts]
            w3_full = (col.fsdp_gather(parts[3], 0, data, summed) if d % data.size == 0
                       else parts[3])
            y, a = net(*parts[:3], w3_full, split=True)
            loss = loss_of(y, a, w3_full)  # a data rank's rows: its part of the sum
            grads = torch.autograd.grad(loss, parts)
            total = data.all_reduce(loss.detach()) if summed else loss.detach()
            tag = "summed" if summed else "whole_rows"
            out[f"{tag}_loss"] = float((total - whole_loss.detach()).abs())
            if summed and d % data.size:  # a whole w3 sums its data ranks' gradients here
                grads = grads[:3] + (data.all_reduce(grads[3].contiguous()),)
            want = [whole[0][data.rank * rows:(data.rank + 1) * rows] if summed else whole[0],
                    whole[1][:, model.rank * cols:(model.rank + 1) * cols],
                    whole[2][model.rank * cols:(model.rank + 1) * cols],
                    whole[3][data.rank * (d // data.size):(data.rank + 1) * (d // data.size)]
                    if d % data.size == 0 else whole[3]]
            if summed:  # the data-replicated weights' gradients summed over data
                grads = (grads[0],) + tuple(
                    data.all_reduce(g.contiguous()) for g in grads[1:3]) + (grads[3],)
            for name, g, wnt in zip(("x", "w1", "w2", "w3"), grads, want):
                out[f"{tag}_{name}"] = float((g - wnt).abs().max())
        return out


@dataclasses.dataclass
class DriverTrain:
    """The training driver, ``launch.train.run(args, mesh=, cfg=)``, on
    ``argv`` on a mesh of ``shape`` (``cfg``: a config cut in depth, in
    place of the registry's config of ``--arch``).  Returns the printed
    keys, the losses, each step's seconds, the rank's kernel launches over
    the run and its peak device GiB.  With ``grads_to``, rank 0 also
    writes (``torch.save``) the gradients of the step after the run: the
    trained model's gradients before clipping (gathered over both axes)
    on the batch the driver would take next, as a resumed driver draws it,
    with that step's loss and index."""
    argv: List[str]
    cfg: Optional[ModelConfig] = None
    shape: Tuple[int, int] = (2, 2)
    grads_to: str = ""
    count: bool = False     # each step's collectives and peak bytes (``steps``)

    def run(self, mesh, device):
        from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset, batch_for_model
        from repro_torch.kernels import dispatch
        from repro_torch.launch import train as train_lib
        from repro_torch.sharding import partition
        from repro_torch.training import step as step_lib

        args = train_lib.build_argparser().parse_args(self.argv)
        for k in dispatch.KERNELS.values():
            k.launches = 0
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        steps: List[Dict[str, Any]] = []
        counted = _Counted(mesh, device, steps) if self.count else None
        try:
            printed, rec = train_lib.run(
                args, mesh=mesh, cfg=self.cfg,
                around_step=counted and (lambda i: counted.measured(step=i)))
        finally:
            if counted:
                mesh.count(None)
        peak = counted.peak() if counted else (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None)
        out = dict(out=printed, losses=rec.losses, seconds=rec.seconds,
                   launches={n: k.launches for n, k in dispatch.KERNELS.items()},
                   peak_gib=peak / 2**30 if peak is not None else None, steps=steps)
        model, rec.state = rec.state.model, None
        if self.grads_to:
            cfg, nxt = model.cfg, len(rec.losses)
            ds = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                                  batch_size=args.batch, seed=args.seed))
            batch = batch_for_model(cfg, ds.batch_at(nxt), np.random.default_rng(args.seed))
            aux, grads = step_lib.grads_of(
                step_lib.make_loss_fn(cfg, remat=args.remat), model,
                {k: torch.from_numpy(v).to(device) for k, v in batch.items()}, mesh,
                args.microbatches)
            full = partition.gather_params(grads, model.placement)
            if mesh.rank == 0:
                torch.save({"step": nxt, "loss": float(aux["loss"]), "grads": full},
                           self.grads_to)
        return out


class _Counted:
    """``mesh``'s collectives counted (``Mesh.count``) for the work inside
    ``measured(**tags)``, each such span appended to ``records`` with its
    tags, its collectives (``CollectiveLog.summary``), its host seconds
    and, on a GPU, the bytes allocated at its start and at its peak;
    ``peak`` is the peak over everything since it began (each span resets
    the allocator's)."""

    def __init__(self, mesh, device, records: List[Dict[str, Any]]):
        from repro_torch.sharding.record import CollectiveLog

        self.log, self.device, self.records = CollectiveLog(), device, records
        self.cuda = device.type == "cuda"
        self.seen = 0
        mesh.count(self.log)

    def peak(self) -> Optional[int]:
        if not self.cuda:
            return None
        return max(self.seen, torch.cuda.max_memory_allocated(self.device))

    @contextlib.contextmanager
    def measured(self, **tags):
        mark, base = self.log.mark(), None
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.seen = self.peak()
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        t0 = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.records.append(dict(tags, collectives=self.log.summary(mark), base_bytes=base,
                                 seconds=time.perf_counter() - t0,
                                 peak_bytes=(torch.cuda.max_memory_allocated(self.device)
                                             if self.cuda else None)))


@dataclasses.dataclass
class MeshLogits:
    """A prefill and decode steps on a ``("data", "model")`` mesh of
    ``shape`` (or whole, with the plan's mesh None): the rank's shard of
    ``params`` (the port's names -> full arrays) or of the weights drawn
    from ``seed``; ``tokens`` (B, S) prefilled (after ``vision`` (B, nv,
    d) patch embeddings, over ``enc`` (B, T, d) frames), the rank's rows
    of it (``partition.rank_rows``) into its cache
    (``partition.rank_cache``), then one decode step on each row of
    ``steps`` (n, B), or with ``steps`` None ``greedy`` steps on each
    step's argmax.  Returns the rank's fp32 ``logits`` (n + 1, rows,
    vocab), its first ``row`` of the batch, its kernel ``launches`` over
    the job, the job's host ``seconds`` (the weights drawn or placed
    too), and for the prefill and each decode step its collectives, host
    seconds and (on a GPU) the bytes allocated at its start and at its
    peak (``phases``).

    With ``serve`` the decode steps run under the serve rules
    (``rules.use_serve_rules``: weight-stationary, on the prefill's
    cache), each given the rank's rows of the token and of the positions,
    and each returning the whole batch's logits; the prefill's rows are
    gathered over data after its phase, so ``logits`` is (n + 1, B,
    vocab) on every rank and ``row`` 0.  ``pods`` > 1 splits the data
    axis into pods (``launch.mesh.make_mesh``)."""
    cfg: ModelConfig
    tokens: np.ndarray
    max_len: int
    steps: Optional[np.ndarray] = None
    greedy: int = 0
    shape: Tuple[int, int] = (2, 2)
    params: Optional[Dict[str, np.ndarray]] = None
    seed: int = 0
    enc: Optional[np.ndarray] = None
    vision: Optional[np.ndarray] = None
    serve: bool = False
    pods: int = 1

    def run(self, mesh, device):
        from repro_torch.kernels import dispatch
        from repro_torch.models import model as model_lib
        from repro_torch.sharding import collectives, partition, rules

        cfg = self.cfg
        t0 = time.perf_counter()
        if mesh is None:
            model = (_whole_model(cfg, self.params, device) if self.params is not None
                     else model_lib.init(cfg, torch.Generator(device=device).manual_seed(
                         self.seed), device))
        elif self.params is not None:
            model = partition.shard_params(cfg, self.params, mesh)
        else:
            model = partition.shard_model(cfg, mesh, self.seed)
        for k in dispatch.KERNELS.values():
            k.launches = 0
        phases: List[Dict[str, Any]] = []
        measured = (_Counted(mesh, device, phases).measured if mesh is not None
                    else lambda **_: contextlib.nullcontext())
        batch = {"tokens": torch.from_numpy(self.tokens).to(device)}
        for key, a in (("enc_embeds", self.enc), ("vision_embeds", self.vision)):
            if a is not None:
                batch[key] = torch.from_numpy(a).to(device, getattr(torch, cfg.dtype))
        B, S = self.tokens.shape
        nv = cfg.num_vision_tokens if self.vision is not None else 0
        serve = rules.use_serve_rules if self.serve else contextlib.nullcontext
        try:
            rows = partition.rank_rows(model, batch)
            n_rows = rows["tokens"].shape[0]
            row = mesh.data.rank * n_rows if mesh is not None and n_rows < B else 0
            cache = partition.rank_cache(model, B, self.max_len)
            with measured(phase="prefill"):
                logits = model.prefill(rows, cache)[0]
            out = [logits]
            if self.serve and n_rows < B:  # the whole batch, as the decode steps give it
                out = [collectives.gather(logits, 0, mesh.data)]
            n = self.greedy if self.steps is None else len(self.steps)
            for i in range(n):
                if self.steps is None:  # the rank's rows of the argmax
                    tok = logits.argmax(-1, keepdim=True)
                    tok = tok[row:row + n_rows] if tok.shape[0] > n_rows else tok
                else:
                    tok = torch.from_numpy(np.asarray(self.steps[i])).to(device)[:, None]
                    tok = partition.rank_rows(model, {"token": tok})["token"]
                pos = nv + S + i
                if self.serve:
                    pos = torch.full((n_rows,), pos, dtype=torch.int32, device=device)
                with measured(phase=f"decode {i}"), serve():
                    logits, cache = model.decode_step(tok, pos, cache)
                out.append(logits)
        finally:
            if mesh is not None:
                mesh.count(None)
        return dict(logits=torch.stack(out).float().cpu().numpy(),
                    row=0 if self.serve else row,
                    launches={name: k.launches for name, k in dispatch.KERNELS.items()},
                    seconds=time.perf_counter() - t0, phases=phases)


def _whole_model(cfg: ModelConfig, params: Dict[str, np.ndarray], device):
    from repro_torch.bridge import as_tensor
    from repro_torch.models import model as model_lib

    model = model_lib.Model(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(as_tensor(params[name]))
    return model


def train_plan(mesh, jobs: List[Any], device="cpu") -> List[Any]:
    """Each job (``Train``, ``CollectiveGrads``, ``DriverTrain``,
    ``MeshLogits``) on a mesh of its ``shape``
    made from ``mesh``'s ranks (every rank makes every job's mesh, in
    order), or on ``device`` whole where ``mesh`` is None; a GPU's cached
    blocks are released after each job, for the next one's."""
    from repro_torch.launch import mesh as mesh_lib

    results = []
    for job in jobs:
        if mesh is None:
            results.append(job.run(None, torch.device(device)))
            continue
        pods = getattr(job, "pods", 1)
        sub = mesh if (tuple(job.shape), pods) == (tuple(mesh.shape), mesh.pods) else \
            mesh_lib.make_mesh(job.shape, mesh.device, mesh.backend, pods=pods)
        results.append(job.run(sub, sub.device))
        if sub.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
        mesh.barrier()
    return results
