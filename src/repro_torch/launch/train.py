"""Training driver of the port, the counterpart of
``repro/launch/train.py``: synthetic data with background prefetch, the
AdamW train step with gradient accumulation, atomic checkpoints with
sample-exact resume, preemption handling, the straggler watchdog and,
with ``--energy``, the energy of the whole run.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 20 --batch 8 \
        --seq-len 1024 --ckpt-dir /tmp/run1 --energy
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu \
        --steps 10 --batch 4 --seq-len 32 --ckpt-dir /tmp/run1

Every architecture of the registry: the dense decoders, RG-LRU, xLSTM,
MoE, encoder-decoder (frame embeddings drawn beside the tokens) and
vision-prefix (patch embeddings drawn beside the tokens, the loss over the
text positions).  The weights are drawn from ``--seed`` on the device;
parameters keep the config's dtype (bf16 at full size) and the moments
are fp32.  ``--energy`` reads NVML on the GPU and /proc/stat on the CPU
over the steps and the end-of-run checkpoint's write, as the reference's
window does.  Prints the reference's output keys as JSON.

Meshes, as the reference's: ``--mesh host`` puts every rank of the world
on ``data`` (one rank, under a plain ``python -m``, is the one-device
run), ``--mesh production`` is the 16 x 16 ``("data", "model")`` mesh of
256 ranks.  Ranks start under ``torchrun`` (or are handed a mesh:
``run(args, mesh=)``, ``launch.mesh.spawn_mesh``)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh host --device cpu \
        --arch tinyllama-1.1b --smoke --steps 10 --batch 8 --seq-len 32

On a mesh every rank draws the same weights and the same global batch
from ``--seed`` and keeps its slices (``sharding.partition``), so no batch
crosses ranks; the ranks agree on preemption before each step (an
all-reduce of the flag); checkpoints are gathered and written by rank 0,
in the one-device layout, and restore onto any mesh.  Rank 0 prints; with
``--energy`` its NVML window covers every GPU of the mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import energy as energy_lib
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset, batch_for_model
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import partition
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import step as step_lib
from repro_torch.training.fault import PreemptionHandler, RunPosition, StragglerWatchdog
from repro_torch.training.optimizer import AdamW, warmup_cosine_schedule

def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=["host", "production"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--energy", action="store_true",
                    help="sample power (NVML on the GPU, /proc/stat on the CPU) during the run")
    ap.add_argument("--remat", action="store_true", default=False)
    return ap


@dataclasses.dataclass
class TrainRun:
    """What ``run`` did beyond the printed keys: each step's index, loss,
    seconds and ``perf_counter`` stamp at its end, the final state and,
    with ``--energy``, the power monitor (``joules_between`` those
    stamps)."""
    steps: List[int]
    losses: List[float]
    seconds: List[float]
    ends: List[float]
    state: step_lib.TrainState
    monitor: Optional[energy_lib.PowerMonitor] = None


def _tree(state: step_lib.TrainState) -> Dict:
    return {"params": state.params(), "opt_mu": state.opt.mu, "opt_nu": state.opt.nu}


def _save(args, state: step_lib.TrainState, step: int, placement=None) -> None:
    ckpt_lib.save(args.ckpt_dir, step, _tree(state),
                  metadata=RunPosition(step=step, data_epoch=0, data_offset=step,
                                       rng_seed=args.seed).to_metadata(),
                  placement=placement)


def _mesh(args):
    """The mesh ``--mesh`` names over the world's ranks; None for one rank
    on the host mesh (the one-device run, no process group)."""
    if args.mesh == "production":
        return mesh_lib.make_production_mesh(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return mesh_lib.make_host_mesh(args.device)
    return None


def _mesh_gpus(mesh) -> List[int]:
    """The indices of every GPU the mesh's ranks run on (on each rank)."""
    every = [None] * mesh.size
    torch.distributed.all_gather_object(every, mesh.device.index, group=mesh.host_group)
    return sorted(set(every))


def run(args, mesh=None, cfg=None, around_step: Optional[Callable[[int], ContextManager]] = None
        ) -> Tuple[Dict[str, float], TrainRun]:
    """Train as ``args`` say, on ``mesh`` (a ``launch.mesh.Mesh`` this
    process is a rank of) or the one ``--mesh`` names; ``cfg`` in place of
    ``--arch``'s config (one cut in depth, say).  ``around_step(i)``: a
    context each step i runs in, its loss read inside (a caller's
    measurement of one step)."""
    if mesh is None:
        mesh = _mesh(args)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    opt = AdamW(schedule=warmup_cosine_schedule(args.lr, args.warmup, args.steps))
    if mesh is None:
        state = step_lib.init_state(
            cfg, opt, torch.Generator(device=device).manual_seed(args.seed), device)
    else:
        state = step_lib.train_state(partition.shard_model(cfg, mesh, args.seed), opt)
    placement = state.model.placement
    train_step = step_lib.make_train_step(cfg, opt, remat=args.remat,
                                          microbatches=args.microbatches, mesh=mesh)
    ds = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                                          batch_size=args.batch, seed=args.seed))
    pos = RunPosition(step=0, data_epoch=0, data_offset=0, rng_seed=args.seed)

    # resume from the latest checkpoint
    if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        restored, manifest = ckpt_lib.restore(args.ckpt_dir, _tree(state), device=device,
                                              placement=placement)
        pos = RunPosition.from_metadata(manifest)
        with torch.no_grad():
            for live, saved in ((state.params(), restored["params"]),
                                (state.opt.mu, restored["opt_mu"]),
                                (state.opt.nu, restored["opt_nu"])):
                for k, t in live.items():
                    t.copy_(saved[k])
        state.opt.count = state.step = pos.step
        if lead:
            print(f"resumed from step {pos.step}", flush=True)

    handler = PreemptionHandler().install()
    watchdog = StragglerWatchdog(threshold=3.0)
    monitor = None
    gpus = ([device.index] if mesh is None else _mesh_gpus(mesh)) if device.type == "cuda" else []
    if args.energy and lead:
        reader = energy_lib.NvmlReader(gpus) if gpus else energy_lib.ProcStatReader()
        monitor = energy_lib.PowerMonitor(reader)
        monitor.__enter__()

    rng = np.random.default_rng(args.seed)

    def batches():
        i = pos.step
        while True:
            yield i, batch_for_model(cfg, ds.batch_at(i), rng)
            i += 1

    it = Prefetcher(batches(), depth=2)
    record = TrainRun(steps=[], losses=[], seconds=[], ends=[], state=state, monitor=monitor)
    t_start = time.perf_counter()
    final_step = pos.step
    stopped = False
    try:
        for i, host_batch in it:
            stop = handler.preemption_requested
            if mesh is not None:  # every rank stops before the same step
                stop = mesh.any(stop)
            if i >= args.steps or stop:
                stopped = bool(stop)
                break
            batch = {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()}
            watchdog.start_step()
            with around_step(i) if around_step else contextlib.nullcontext():
                metrics = train_step(state, batch)
                loss = float(metrics["loss"])  # waits for the step
            timing = watchdog.end_step(i)
            record.steps.append(i)
            record.losses.append(loss)
            record.seconds.append(timing.seconds)
            record.ends.append(time.perf_counter())
            final_step = i + 1
            if i % args.log_every == 0 and lead:
                print(f"step {i:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {timing.seconds * 1e3:.0f}ms", flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                _save(args, state, i + 1, placement)
        # preemption / end-of-run checkpoint, inside the energy window
        if args.ckpt_dir:
            _save(args, state, final_step, placement)
    finally:
        it.close()
        handler.uninstall()
        if monitor is not None:
            monitor.__exit__(None, None, None)
    wall = time.perf_counter() - t_start
    losses = record.losses
    out = {
        "steps": len(losses),
        "final_step": final_step,
        "loss_first": losses[0] if losses else float("nan"),
        "loss_last": losses[-1] if losses else float("nan"),
        "mean_step_ms": watchdog.mean_step_s * 1e3,
        "stragglers": watchdog.straggler_count,
        "wall_s": wall,
        "preempted": stopped if mesh is not None else handler.preemption_requested,
    }
    if monitor is not None:
        e = monitor.result()
        out["avg_watts"] = e.avg_watts
        out["joules"] = e.joules
        out["j_per_step"] = e.joules / max(len(losses), 1)
    return out, record


def train(args) -> Dict[str, float]:
    return run(args)[0]


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    out, _ = run(args)
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(out, indent=2))
    if torch.distributed.is_initialized():  # a mesh this process joined
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
