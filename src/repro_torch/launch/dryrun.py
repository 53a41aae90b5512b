"""Dry-run: count every (architecture x input-shape) cell on the ``meta``
device against the H100, the counterpart of ``repro/launch/dryrun.py``,
per device on the production mesh.

Per cell, the step the reference lowers is run on meta tensors:

  * ``train``: the train step (``training/step.py``) with remat and the
    reference's microbatches, forward, backward and AdamW;
  * ``prefill``: ``Model.prefill`` into a fresh cache;
  * ``decode``: ``Model.decode_step`` against a cache of ``seq_len``.

Twice.  Whole, at the cell's global shapes, under ``core/cost.py``'s
counter: the whole program's matrix-product FLOPs (``flops_global``, the
counterpart of the reference's ``flops_unrolled_global``; eager PyTorch
runs every loop, so nothing is visited once and corrected) and the bytes
of its arguments.  Then as rank 0 of the ``(data, model)`` mesh
(``mesh=(dp, tp)``, 16 x 16 by default; ``--multi-pod`` the reference's
two pods, a data axis of 32 over pod and data): its arguments built on
meta without drawing a weight (``rank_arguments``: its parameter and
moment shards, ``sharding/partition.py``; its cache shard; its batch
rows), its step run against a ``sharding.record.RecordingMesh``, which
counts every collective the port's own code issues on the rank (FSDP's
gathers and reduce-scatters, the tensor-parallel reduces and gathers, the
loss's and the norm's all-reduces), under the counter and the live-bytes
tracker (``core/cost.py:LiveBytes``).  That gives the per-device
arguments, outputs, temp (peak live bytes beyond the arguments) and
peak estimate (arguments + temp, the reference's), the rank's FLOPs and
its collectives by kind.  The one loop whose trip count would stall a
sweep, the sLSTM's time loop (one Python step per position), is folded
into one pass with the same products (``models/flags.fold_loops``).

The roofline terms on ``h100`` (``core/hardware.py``: 989 TFLOP/s bf16,
67 fp32, 3.35 TB/s, NVLink 18 x 25 GB/s): compute, the global FLOPs split
evenly over the chips; memory, the rank's argument bytes read once;
collective, the rank's collective bytes over the links.

Nothing is allocated off ``meta`` and nothing is launched: the dry-run has
no device argument.  ``--opt moe_block`` routes MoE layers through the
blocked dispatch; ``shard_grads`` counts the same program (the port's
FSDP always reduce-scatters a gradient into its shard); ``serve_repl``
counts a decode cell's rank step under the serve rules
(``sharding.rules.use_serve_rules``: weight-stationary, the residual
stream split over data, the batch whole) and a train or prefill cell's
as without it, as the reference's does; a config with a block the serve
rules do not run (MoE, RG-LRU, mLSTM, sLSTM) is refused by name
(``rules.check_serve``), and the command line records its cells as
skipped with that reason.  The
whole-program FLOPs are the mesh-free step's either way.

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--shapes train_4k,...]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.core import cost as cost_lib
from repro_torch.core import size as size_prof
from repro_torch.core.hardware import H100
from repro_torch.models import cache as cache_lib
from repro_torch.models import flags
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.model import Model
from repro_torch.sharding import partition, record
from repro_torch.sharding import rules as rules_lib
from repro_torch.training import step as step_lib
from repro_torch.training.optimizer import AdamW, constant_schedule

# one H100's peak by activation dtype: NVIDIA's data sheet (SXM, dense);
# fp32 outside the tensor cores
PEAK_FLOPS = {"bfloat16": H100.peak_flops_bf16, "float32": 67e12}

# the reference's gradient-accumulation splits for train_4k (global batch 256)
TRAIN_MICROBATCHES = {
    "default": 8,
    "command-r-plus-104b": 16,
    "llava-next-34b": 16,
    "minitron-4b": 8,
    "seamless-m4t-large-v2": 8,
}

# the reference's production meshes: (data 16, model 16), and two pods of it,
# (pod 2, data 16, model 16), whose data axis is pod x data
MESH = (16, 16)
MESH_MULTI_POD = (2, 16, 16)
OPTS = ("moe_block", "shard_grads", "serve_repl")
# the H100's NVLink: 18 links of 25 GB/s each way (``core/hardware.py``)
LINK_BW = H100.link_bw * H100.num_links

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_results"

NOTES = [
    "flops count matrix products only (FlopCounterMode); the reference's cost_analysis "
    "also counts elementwise operations",
    "flops_global and compute_term_s: the whole program's count split evenly over `chips` "
    "H100s (989 TFLOP/s bf16, 67 TFLOP/s fp32); memory_term_s: rank 0's argument bytes "
    "read once at 3.35 TB/s",
    "per device: rank 0 of the (data, model) mesh, its step run on meta against a "
    "recording mesh; temp_bytes_per_device is the peak of live bytes beyond the arguments "
    "(a live-bytes tracker, not XLA's buffer assignment), each kernel counted as the card "
    "allocates for it (its outputs, a split launch's workspace) and its backward's plain "
    "VJP in full; flops_perdev_* count that VJP's recompute too",
    "collectives: every collective of the whole step, bytes of the result by the "
    "reference's convention (all-reduce the tensor, all-gather the gathered whole, "
    "reduce-scatter the rank's part); eager PyTorch has no loop body visited once, so the "
    "'once' and 'corrected' counts are equal",
    "collective_term_s: bytes over the H100's NVLink, 18 links x 25 GB/s; a 16-wide axis "
    "leaves an 8-GPU NVLink domain, so this is a lower bound",
    "shard_grads: the port's FSDP always reduce-scatters a data-sharded leaf's gradient "
    "into its shard, so with or without it the port runs (and counts) one program",
    "serve_repl: a decode cell's rank step is weight-stationary (the residual stream split "
    "over data, the batch whole, no weight gathered); a train or prefill cell counts the "
    "same program as without it",
]


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Meta tensors for every model input of this cell, with the
    reference's keys, shapes and dtypes; a decode cell's cache is the
    port's, one entry per layer."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        tok_len = S
        batch = {}
        if cfg.num_vision_tokens:
            tok_len = S - cfg.num_vision_tokens
            batch["vision_embeds"] = spec((B, cfg.num_vision_tokens, cfg.d_model), dt)
        if cfg.is_encdec:
            tok_len = S // 2
            batch["enc_embeds"] = spec((B, S // 2, cfg.d_model), dt)
        batch["tokens"] = spec((B, tok_len))
        if shape.kind == "train":
            batch["labels"] = spec((B, tok_len))
        return batch
    if shape.kind == "decode":
        return {"token": spec((B, 1)), "positions": spec((B,)),
                "cache": cache_lib.init_cache(cfg, B, S, dt, "meta")}
    raise ValueError(shape.kind)


def should_skip(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention architecture: 500k-token decode requires "
                "sub-quadratic attention (DESIGN.md §4)")
    return None


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference)."""
    n = size_prof.profile_size(cfg).active_param_count
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one decoded token per sequence


def count_step(cfg: ModelConfig, shape: ShapeConfig, remat: bool = True
               ) -> cost_lib.CostSummary:
    """The cell's step counted on meta: its FLOPs and its arguments' bytes."""
    model = Model(cfg, device="meta")
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = AdamW(schedule=constant_schedule(1e-4))
        state = step_lib.train_state(model, opt)
        fn = step_lib.make_train_step(cfg, opt, remat=remat, microbatches=shape.microbatches)
        return cost_lib.summarize_call(fn, state, specs)
    if shape.kind == "prefill":
        cache = cache_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     getattr(torch, cfg.dtype), "meta")
        return cost_lib.summarize_call(lambda m, b, c: m.prefill(b, c), model, specs, cache)
    return cost_lib.summarize_call(lambda m, t, pos, c: m.decode_step(t, pos, c), model,
                                   specs["token"], specs["positions"], specs["cache"])


def check_opts(opts) -> frozenset:
    opts = frozenset(opts)
    for o in sorted(opts):
        if o not in OPTS:
            raise ValueError(f"unknown --opt {o!r}; known: {OPTS}")
    return opts


def mesh_axes(mesh) -> Tuple[int, int, int]:
    """(dp, tp, pods) of ``mesh``: (data, model), or (pod, data, model)
    with the data axis over pod x data."""
    if len(mesh) == 3:
        pods, data, tp = (int(n) for n in mesh)
        return pods * data, tp, pods
    dp, tp = (int(n) for n in mesh)
    return dp, tp, 1


@dataclasses.dataclass
class RankArguments:
    """Rank 0's arguments of a cell's step on a recording mesh, on meta:
    its model (parameter shards), train state, cache, the global ``batch``
    (which a train step takes, cutting its rows itself) and the rank's
    ``rows`` of it (which a prefill or a decode step takes).  ``bytes``
    splits their per-device bytes: ``params``, ``opt`` (the moments),
    ``cache``, ``batch`` (the rank's rows)."""
    mesh: record.RecordingMesh
    model: Model
    state: Optional[step_lib.TrainState]
    batch: Dict
    rows: Dict
    cache: Optional[list]
    bytes: Dict[str, int]

    @property
    def total(self) -> int:
        return sum(self.bytes.values())


def rank_arguments(cfg: ModelConfig, shape: ShapeConfig, mesh=MESH) -> RankArguments:
    """Rank 0's arguments of the cell's step on ``mesh``, built on meta
    without drawing a weight: ``partition._rank_model`` with a recording
    mesh as both axes, its train state (a train cell), its cache shard
    (``partition.rank_cache``: batch over data where dp divides it, model
    dims by ``rules.cache_dim``) and its batch rows (``batch_rows``).  A
    decode cell under the serve rules holds its norm scales' data slices
    (``partition.Placement(serve=True)``)."""
    dp, tp, pods = mesh_axes(mesh)
    rec = record.RecordingMesh((dp, tp), pods=pods)
    model = partition._rank_model(cfg, rec, rules_lib.serve_rules() and shape.kind == "decode")
    specs = input_specs(cfg, shape)
    state, cache, batch = None, None, specs
    if shape.kind == "train":  # the step takes the global batch and cuts its rows
        state = step_lib.train_state(model, AdamW(schedule=constant_schedule(1e-4)))
        rows = partition.batch_rows(specs, rec)[0]
    else:
        if shape.kind == "decode":
            batch = {"token": specs["token"], "positions": specs["positions"]}
        cache = partition.rank_cache(model, shape.global_batch, shape.seq_len)
        rows = partition.rank_rows(model, batch)
    parts = {"params": cost_lib.tree_bytes(model),
             "opt": cost_lib.tree_bytes(state.opt.mu, state.opt.nu) if state else 0,
             "cache": cost_lib.tree_bytes(cache) if cache is not None else 0,
             "batch": cost_lib.tree_bytes(rows)}
    return RankArguments(rec, model, state, batch, rows, cache, parts)


def count_rank_step(cfg: ModelConfig, shape: ShapeConfig, mesh=MESH, remat: bool = True
                    ) -> Tuple[RankArguments, cost_lib.CostSummary, Dict]:
    """Rank 0's step of the cell on ``mesh``, counted on meta: (its
    arguments, its FLOPs, output bytes and temp bytes, its collectives'
    ``CollectiveLog.summary``).  The step returns what the reference's
    returns: the train state and the metrics, or the logits and the
    cache."""
    args = rank_arguments(cfg, shape, mesh)
    model, rec = args.model, args.mesh
    if shape.kind == "train":
        fn = step_lib.make_train_step(cfg, AdamW(schedule=constant_schedule(1e-4)),
                                      remat=remat, microbatches=shape.microbatches, mesh=rec)
        summary = cost_lib.summarize_call(lambda st, b: (st, fn(st, b)), args.state, args.batch,
                                          track=True)
    elif shape.kind == "prefill":
        summary = cost_lib.summarize_call(lambda m, b, c: m.prefill(b, c), model, args.rows,
                                          args.cache, track=True)
    else:
        summary = cost_lib.summarize_call(lambda m, t, pos, c: m.decode_step(t, pos, c), model,
                                          args.rows["token"], args.rows["positions"],
                                          args.cache, track=True)
    return args, summary, rec.log.summary()


def run_cell(arch: str, shape: Union[str, ShapeConfig], *, mesh=MESH, opts=frozenset(),
             cfg: Optional[ModelConfig] = None, remat: bool = True) -> Dict:
    """One cell on ``mesh``: (data, model), or (pod, data, model) (the
    reference's multi-pod mesh, a data axis of pod x data).  ``shape``
    names a ``SHAPES`` cell (a train cell then takes the reference's
    microbatches, capped by the data axis) or is a ``ShapeConfig``, taken
    as it is.  ``cfg``: a config in place of the registry's (one cut in
    depth, say); ``remat`` False counts a train step without remat (the
    reference's dry-run always remats), as a driver without ``--remat``
    runs it.  ``serve_repl`` counts a decode cell's rank step under the
    serve rules, and raises ``rules.ServeRefusal`` (a ``ValueError``) for
    a config whose blocks they do not run."""
    opts = check_opts(opts)
    cfg = cfg or get_config(arch)
    if "serve_repl" in opts:
        rules_lib.check_serve(cfg)
    dp, tp, pods = mesh_axes(mesh)
    chips = dp * tp
    if isinstance(shape, str):
        shape = SHAPES[shape]
        if shape.kind == "train":
            mb = TRAIN_MICROBATCHES.get(arch, TRAIN_MICROBATCHES["default"])
            # per-microbatch batch stays divisible by the data-parallel size
            shape = dataclasses.replace(
                shape, microbatches=min(mb, max(shape.global_batch // dp, 1)))
    result: Dict = {"arch": arch, "shape": shape.name, "mesh": "x".join(str(n) for n in mesh),
                    "chips": chips, "kind": shape.kind, "device": "meta"}
    skip = should_skip(cfg, shape)
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        return result

    result["opts"] = sorted(opts)
    result["remat"] = remat
    moe_ctx = flags.use_moe_blocked() if "moe_block" in opts else contextlib.nullcontext()
    serve = "serve_repl" in opts and shape.kind == "decode"
    t0 = time.perf_counter()
    with moe_ctx, flags.use_fold_loops():
        summary = count_step(cfg, shape, remat)
        t1 = time.perf_counter()
        with rules_lib.use_serve_rules() if serve else contextlib.nullcontext():
            args, rank, coll = count_rank_step(cfg, shape, mesh, remat)
    t2 = time.perf_counter()

    peak = PEAK_FLOPS[cfg.dtype]
    flops, nbytes = summary.flops, summary.argument_bytes
    mf = model_flops(cfg, shape)
    terms = {"compute": flops / (chips * peak),
             "memory": args.total / H100.hbm_bw,
             "collective": coll["bytes"] / LINK_BW}
    dominant = max(terms, key=terms.get)
    result.update({
        "status": "ok",
        "count_s": t1 - t0,
        "rank_count_s": t2 - t1,
        "lower_s": None,
        "compile_s": None,
        "memory": {
            "argument_bytes_global": nbytes,
            "argument_bytes_per_device": args.total,
            "argument_bytes_by_part": args.bytes,
            "output_bytes_per_device": rank.output_bytes,
            "temp_bytes_per_device": rank.temp_bytes,
            "peak_bytes_estimate": args.total + rank.temp_bytes,
        },
        "cost": {
            "flops_unrolled_global": flops,
            "flops_global": flops,
            "flops_by_op": summary.ops,
            "flops_perdev_compiled_once": rank.flops,
            "flops_perdev_corrected": rank.flops,
            "bytes_perdev_compiled_once": None,
            "bytes_perdev_corrected": None,
            "microbatches": shape.microbatches,
        },
        "collectives": {
            "counts": coll["counts"],
            "bytes_by_kind_perdev_once": coll["bytes_by_kind"],
            "bytes_perdev_once": coll["bytes"],
            "bytes_perdev_corrected": coll["bytes"],
            "bytes_by_axis_perdev": coll["bytes_by_axis"],
            "by_axis_kind_perdev": coll["by_axis_kind"],
        },
        "roofline": {
            "hardware": H100.name,
            "peak_flops": peak,
            "hbm_bw": H100.hbm_bw,
            "link_bw": LINK_BW,
            "split": f"compute split evenly over {chips} chips; memory and collectives "
                     f"per device",
            "compute_term_s": terms["compute"],
            "memory_term_s": terms["memory"],
            "collective_term_s": terms["collective"],
            "bound_s": terms[dominant],
            "dominant": dominant,
            "model_flops": mf,
            "useful_flops_ratio": mf / max(flops, 1.0),
        },
        "notes": NOTES,
    })
    return result


def _cell_job(job) -> Tuple[Dict, Dict[str, int]]:
    """``run_cell(arch, shape, **kw)`` of ``job`` = (arch, shape, kw) and
    the kernel launches this process counted meanwhile (none: meta)."""
    from repro_torch.kernels import dispatch

    arch, shape, kw = job
    before = {name: k.launches for name, k in dispatch.KERNELS.items()}
    res = run_cell(arch, shape, **kw)
    return res, {name: k.launches - before[name] for name, k in dispatch.KERNELS.items()}


def run_cells(jobs, workers: int = 1):
    """``run_cell(arch, shape, **kw)`` for each ``(arch, shape, kw)`` of
    ``jobs``, in ``workers`` processes side by side (one intra-op thread
    each; a cell runs on one core); (result, launches) per job, in
    order."""
    jobs = list(jobs)
    if workers <= 1:
        return [_cell_job(job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(min(workers, len(jobs)), mp_context=ctx,
                                                initializer=torch.set_num_threads,
                                                initargs=(1,)) as pool:
        return list(pool.map(_cell_job, jobs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--shapes", default=None, help="comma-separated")
    ap.add_argument("--all", action="store_true",
                    help="every cell of the reference's ten assigned architectures")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod 2, data 16, model 16) mesh of 512 chips, not 16 x 16")
    ap.add_argument("--opt", default="", help="comma list: moe_block, shard_grads, serve_repl")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("--arch or --all is required")

    try:
        opts = check_opts(x for x in args.opt.split(",") if x)
    except ValueError as e:
        ap.error(str(e))
    out_dir = Path(args.out_dir) if args.out_dir else RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    archs = ASSIGNED if args.all else [args.arch]
    shapes = (args.shapes.split(",") if args.shapes
              else (list(SHAPES) if (args.all or not args.shape) else [args.shape]))

    failures = 0
    t_all = time.perf_counter()
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch}__{shape_name}__{'2x16x16' if args.multi_pod else '16x16'}"
            if opts:
                tag += "__opt-" + "-".join(sorted(opts))
            print(f"=== {tag} ===", flush=True)
            try:
                res = run_cell(arch, shape_name, opts=opts,
                               mesh=MESH_MULTI_POD if args.multi_pod else MESH)
            except rules_lib.ServeRefusal as e:  # a block the serve rules do not run yet
                res = {"arch": arch, "shape": shape_name, "status": "skipped",
                       "reason": str(e)}
            except Exception:  # a failed cell is recorded, the sweep goes on
                failures += 1
                res = {"arch": arch, "shape": shape_name, "status": "error",
                       "traceback": traceback.format_exc()}
                print(res["traceback"], flush=True)
            with open(out_dir / (tag + ".json"), "w") as f:
                json.dump(res, f, indent=2)
            if res["status"] == "ok":
                r, mem = res["roofline"], res["memory"]
                print(f"  counted in {res['count_s']:.1f} + {res['rank_count_s']:.1f} s | "
                      f"flops {res['cost']['flops_global']:.4e} | "
                      f"args {mem['argument_bytes_global'] / 1e9:.2f} GB, "
                      f"mem/dev {mem['peak_bytes_estimate'] / 1e9:.2f} GB | "
                      f"terms c={r['compute_term_s'] * 1e3:.3f}ms "
                      f"m={r['memory_term_s'] * 1e3:.3f}ms "
                      f"coll={r['collective_term_s'] * 1e3:.3f}ms -> {r['dominant']} | "
                      f"useful={r['useful_flops_ratio']:.3f}", flush=True)
            elif res["status"] == "skipped":
                print(f"  SKIP: {res['reason']}", flush=True)
    print(f"{len(archs) * len(shapes)} cells in {time.perf_counter() - t_all:.1f} s, "
          f"{failures} failed", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
