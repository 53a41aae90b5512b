"""Dry-run: count every (architecture x input-shape) cell on the ``meta``
device against the H100, the counterpart of ``repro/launch/dryrun.py``
without its mesh.

Per cell, the step the reference lowers is run once on meta tensors under
``core/cost.py``'s counter, at the cell's global shapes:

  * ``train``: the train step (``training/step.py``) with remat and the
    reference's microbatches, forward, backward and AdamW;
  * ``prefill``: ``Model.prefill`` into a fresh cache;
  * ``decode``: ``Model.decode_step`` against a cache of ``seq_len``.

The count is the whole program's matrix-product FLOPs (the counterpart of
the reference's ``flops_unrolled_global``): eager PyTorch runs every loop,
so nothing is visited once and corrected.  The one loop whose trip count
would stall a sweep, the sLSTM's time loop (one Python step per
position), is folded into one pass with the same products
(``models/flags.fold_loops``).  ``argument_bytes_global`` is the bytes of
the step's arguments: parameters, optimizer state, cache and batch.  The
roofline terms divide both by ``chips`` H100s (``core/hardware.py``'s
``h100``: 989 TFLOP/s bf16, 67 fp32, 3.35 TB/s), an ideal even split:
the per-device memory and the collectives need the production mesh's
shardings, which the port does not have yet, and are ``null``.

Nothing is allocated off ``meta`` and nothing is launched: the dry-run has
no device argument.  ``--opt moe_block`` routes MoE layers through the
blocked dispatch; ``shard_grads`` and ``serve_repl`` need a mesh and are
refused.

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--shapes train_4k,...]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.core import cost as cost_lib
from repro_torch.core import size as size_prof
from repro_torch.core.hardware import H100
from repro_torch.models import cache as cache_lib
from repro_torch.models import flags
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.model import Model
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

# the reference's production meshes: (data 16, model 16), and two pods of it
CHIPS, CHIPS_MULTI_POD, MODEL_AXIS = 256, 512, 16
OPTS = ("moe_block",)
MESH_OPTS = ("shard_grads", "serve_repl")

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_results"

NOTES = [
    "flops count matrix products only (FlopCounterMode); the reference's cost_analysis "
    "also counts elementwise operations",
    "roofline terms: the global count split evenly over `chips` H100s (989 TFLOP/s bf16, "
    "67 TFLOP/s fp32, 3.35 TB/s); memory_term_s reads each argument byte once",
    "memory.*_per_device and collectives.* need the production mesh's shardings: null "
    "until ROADMAP queue 1 items 2b and 3 (item 4b)",
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


def count_step(cfg: ModelConfig, shape: ShapeConfig) -> cost_lib.CostSummary:
    """The cell's step counted on meta: its FLOPs and its arguments' bytes."""
    model = Model(cfg, device="meta")
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = AdamW(schedule=constant_schedule(1e-4))
        state = step_lib.train_state(model, opt)
        fn = step_lib.make_train_step(cfg, opt, remat=True, microbatches=shape.microbatches)
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
        if o in MESH_OPTS:
            raise ValueError(f"--opt {o} needs the production mesh, which the port's "
                             f"dry-run does not have (ROADMAP item 4b)")
        if o not in OPTS:
            raise ValueError(f"unknown --opt {o!r}; known: {OPTS + MESH_OPTS}")
    return opts


def run_cell(arch: str, shape: Union[str, ShapeConfig], *, chips: int = CHIPS,
             opts=frozenset()) -> Dict:
    """One cell.  ``shape`` names a ``SHAPES`` cell (a train cell then
    takes the reference's microbatches) or is a ``ShapeConfig``, taken as
    it is.  ``chips`` divides the roofline terms."""
    opts = check_opts(opts)
    cfg = get_config(arch)
    if isinstance(shape, str):
        shape = SHAPES[shape]
        if shape.kind == "train":
            mb = TRAIN_MICROBATCHES.get(arch, TRAIN_MICROBATCHES["default"])
            # per-microbatch batch stays divisible by the data-parallel size
            dp = max(chips // MODEL_AXIS, 1)
            shape = dataclasses.replace(
                shape, microbatches=min(mb, max(shape.global_batch // dp, 1)))
    result: Dict = {"arch": arch, "shape": shape.name, "mesh": None, "chips": chips,
                    "kind": shape.kind, "device": "meta"}
    skip = should_skip(cfg, shape)
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        return result

    result["opts"] = sorted(opts)
    moe_ctx = flags.use_moe_blocked() if "moe_block" in opts else contextlib.nullcontext()
    t0 = time.perf_counter()
    with moe_ctx, flags.use_fold_loops():
        summary = count_step(cfg, shape)
    count_s = time.perf_counter() - t0

    peak = PEAK_FLOPS[cfg.dtype]
    flops, nbytes = summary.flops, summary.argument_bytes
    mf = model_flops(cfg, shape)
    compute_term = flops / (chips * peak)
    memory_term = nbytes / (chips * H100.hbm_bw)
    result.update({
        "status": "ok",
        "count_s": count_s,
        "lower_s": None,
        "compile_s": None,
        "memory": {
            "argument_bytes_global": nbytes,
            "argument_bytes_per_device": None,
            "output_bytes_per_device": None,
            "temp_bytes_per_device": None,
            "peak_bytes_estimate": None,
        },
        "cost": {
            "flops_unrolled_global": flops,
            "flops_global": flops,
            "flops_by_op": summary.ops,
            "flops_perdev_compiled_once": None,
            "flops_perdev_corrected": None,
            "bytes_perdev_compiled_once": None,
            "bytes_perdev_corrected": None,
            "microbatches": shape.microbatches,
        },
        "collectives": {
            "counts": None,
            "bytes_by_kind_perdev_once": None,
            "bytes_perdev_once": None,
            "bytes_perdev_corrected": None,
        },
        "roofline": {
            "hardware": H100.name,
            "peak_flops": peak,
            "hbm_bw": H100.hbm_bw,
            "split": f"ideal even split over {chips} chips",
            "compute_term_s": compute_term,
            "memory_term_s": memory_term,
            "collective_term_s": None,
            "bound_s": max(compute_term, memory_term),
            "dominant": "compute" if compute_term >= memory_term else "memory",
            "model_flops": mf,
            "useful_flops_ratio": mf / max(flops, 1.0),
        },
        "notes": NOTES,
    })
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--shapes", default=None, help="comma-separated")
    ap.add_argument("--all", action="store_true",
                    help="every cell of the reference's ten assigned architectures")
    ap.add_argument("--multi-pod", action="store_true", help="512 chips instead of 256")
    ap.add_argument("--opt", default="", help="comma list: moe_block")
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
                res = run_cell(arch, shape_name, chips=CHIPS_MULTI_POD if args.multi_pod
                               else CHIPS, opts=opts)
            except Exception:  # a failed cell is recorded, the sweep goes on
                failures += 1
                res = {"arch": arch, "shape": shape_name, "status": "error",
                       "traceback": traceback.format_exc()}
                print(res["traceback"], flush=True)
            with open(out_dir / (tag + ".json"), "w") as f:
                json.dump(res, f, indent=2)
            if res["status"] == "ok":
                r = res["roofline"]
                print(f"  counted in {res['count_s']:.1f} s | "
                      f"flops {res['cost']['flops_global']:.4e} | "
                      f"args {res['memory']['argument_bytes_global'] / 1e9:.2f} GB | "
                      f"terms c={r['compute_term_s'] * 1e3:.3f}ms "
                      f"m={r['memory_term_s'] * 1e3:.3f}ms -> {r['dominant']} | "
                      f"useful={r['useful_flops_ratio']:.3f}", flush=True)
            elif res["status"] == "skipped":
                print(f"  SKIP: {res['reason']}", flush=True)
    print(f"{len(archs) * len(shapes)} cells in {time.perf_counter() - t_all:.1f} s, "
          f"{failures} failed", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
