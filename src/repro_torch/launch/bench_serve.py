"""Steady-state serving benchmark over HTTP, the counterpart of
``repro/launch/bench_serve.py``.

Stands up the OpenAI-compatible server on an engine in this process,
drives it with the closed- or open-loop load generator (warm-up, then a
fixed steady-state window that the power monitor brackets exactly), and
reports the client's latencies beside the engine's, with the energy
ledger: the per-request token-weighted ``joules_between`` windows must sum
to ``PowerMonitor.result().joules`` exactly.

    python -m repro_torch.launch.bench_serve --arch llama3.1-8b --max-batch 8 \
        --max-len 1024 --prompt-len 256 --max-new 32 --mode closed --concurrency 8 \
        --warmup-s 3 --duration-s 10 --check
    python -m repro_torch.launch.bench_serve --arch tinyllama-1.1b --smoke --device cpu \
        --power-reader synthetic --mode closed --concurrency 2 --warmup-s 1 \
        --duration-s 3 --max-new 8 --check

``--tp N`` shards the model over N rank processes as ``launch.serve``
does (and refuses what it refuses): rank 0 runs the server, the load and the report, the other ranks
follow its steps; one monitor per GPU under NCCL, one in all where the
ranks share a board.

``--check`` turns the protocol's criteria into a non-zero exit where one
fails: requests were measured in the steady state, the client's TTFT and
TPOT agree with the engine's within ``--ttft-tolerance-ms`` (TPOT within a
fifth of it), the energy ledger tiles exactly, and the power sampler
reached half its target rate.  The weights are random, drawn from
``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.bench_serve",
        description="Drive the port's HTTP server with a steady-state load and report "
                    "client and engine latencies and the energy ledger")
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced (CPU-runnable) config variant")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--mode", default="closed", choices=["closed", "open"],
                    help="closed = --concurrency workers, each sending its next request the "
                         "moment the previous one ends; open = Poisson arrivals at --qps "
                         "whatever the completions")
    ap.add_argument("--concurrency", type=int, default=2,
                    help="closed loop: requests in flight")
    ap.add_argument("--qps", type=float, default=4.0, help="open loop: mean arrival rate")
    ap.add_argument("--warmup-s", type=float, default=1.0,
                    help="unmeasured ramp before the steady-state window opens")
    ap.add_argument("--duration-s", type=float, default=5.0,
                    help="steady-state window; only requests sent inside it count")
    ap.add_argument("--max-requests", type=int, default=10_000)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--power-reader", default=None,
                    choices=["nvml", "proc", "model", "synthetic", "none"],
                    help="power source (default: nvml on the GPU, synthetic on the CPU)")
    ap.add_argument("--power-interval", type=float, default=0.1,
                    help="power sample interval in seconds (0.1 = the paper's 10 Hz)")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the protocol held: client/engine latency agreement, "
                         "an exact energy ledger, the sampler's rate")
    ap.add_argument("--ttft-tolerance-ms", type=float, default=250.0,
                    help="--check bound on the mean client-minus-engine TTFT")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: shard the served model over N processes, "
                         "one power monitor per GPU (NCCL, one GPU per rank; with fewer "
                         "GPUs, or on the CPU, gloo ranks with eager steps); every decoder: "
                         "encoder-decoder models, and query heads straddling two KV groups "
                         "unevenly, are refused")
    return ap


def _synthetic_watts(t: float) -> float:
    """A varying waveform, so an exact energy ledger is not trivially so."""
    return 40.0 + 10.0 * math.sin(t * 7.0)


def _check(summary, args) -> None:
    """The measurement protocol's gates."""
    fails = []
    if summary["steady_requests"] < 1:
        fails.append("no requests completed inside the steady-state window "
                     "(increase --duration-s or lower --warmup-s)")
    d_ttft = summary["ttft_client_minus_engine_ms"]
    if not (-1.0 <= d_ttft <= args.ttft_tolerance_ms):
        fails.append(f"client-vs-engine TTFT delta {d_ttft:.1f} ms outside "
                     f"[-1, {args.ttft_tolerance_ms}] ms")
    d_tpot = summary["tpot_client_minus_engine_ms"]
    if abs(d_tpot) > args.ttft_tolerance_ms / 5.0:
        fails.append(f"client-vs-engine TPOT delta {d_tpot:.2f} ms beyond "
                     f"{args.ttft_tolerance_ms / 5.0:.0f} ms")
    if "joules_total" in summary:
        total = summary["joules_total"]
        attributed = summary["joules_attributed"]
        if abs(attributed - total) > 1e-9 * max(abs(total), 1.0):
            fails.append(f"energy ledger drift: per-request windows sum to {attributed!r} J "
                         f"but the run total is {total!r} J")
        min_rate = 0.5 / args.power_interval
        if summary["power_samples_per_sec"] < min_rate:
            fails.append(f"power sampler achieved {summary['power_samples_per_sec']:.1f} Hz, "
                         f"below {min_rate:.1f} Hz (half the configured target)")
    if fails:
        raise SystemExit("--check failed:\n  - " + "\n  - ".join(fails))
    print("# --check passed: steady-state protocol + energy ledger OK")


@dataclasses.dataclass
class Bench:
    result: object          # loadgen.LoadResult: every request sent, and the window's
    engine_summary: dict    # the server's /metrics at the end of the load
    server: object          # the EngineServer, closed: its engine and stamps


def run(args, mesh=None) -> Bench:
    """Draw the model (the rank's shard on ``mesh``, whose rank 0 calls
    this), prewarm the engine, serve it and drive the load.  The other
    ranks follow until the caller closes the engine (``bench.server.engine
    .close()``)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.energy import close_monitor, make_monitor
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.loadgen import LoadSpec, prewarm_engine, run_load
    from repro_torch.serving.server import start_http_server
    from repro_torch.sharding.partition import shard_model

    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    kind = args.power_reader or ("nvml" if device.type == "cuda" else "synthetic")
    shared = mesh is not None and mesh.backend != "nccl"
    monitor = make_monitor(kind, getattr(args, "tp", 1), shared, args.power_interval,
                           _synthetic_watts)
    if mesh is not None:
        print(f"# --tp {mesh.size}: {mesh.describe()}"
              + ("; per-device energy is not split: the ranks share one board or host"
                 if shared and monitor is not None else ""), flush=True)
    try:
        if mesh is None:
            model = model_lib.init(cfg, torch.Generator(device=device).manual_seed(args.seed),
                                   device)
        else:
            model = shard_model(cfg, mesh, args.seed)
        engine = ServingEngine(model, max_batch=args.max_batch, max_len=args.max_len,
                               seed=args.seed, prefill_chunk=args.prefill_chunk, device=device,
                               mesh=mesh, cuda_graph=mesh is None or mesh.capturable)
        if monitor is not None:
            engine.attach_monitor(monitor)
        prewarm_engine(engine, prompt_len=args.prompt_len,
                       concurrency=min(args.concurrency, args.max_batch),
                       vocab_size=cfg.vocab_size, seed=args.seed)
        handle = start_http_server(engine, model_name=cfg.name)
        spec = LoadSpec(mode=args.mode, concurrency=args.concurrency, qps=args.qps,
                        warmup_s=args.warmup_s, duration_s=args.duration_s,
                        max_requests=args.max_requests, prompt_len=args.prompt_len,
                        max_new=args.max_new, temperature=args.temperature,
                        vocab_size=cfg.vocab_size, seed=args.seed)
        print(f"# driving {handle.url} : mode={spec.mode} warmup={spec.warmup_s}s "
              f"window={spec.duration_s}s", flush=True)
        try:
            result = run_load(handle.url, spec, monitor=monitor)
            engine_summary = handle.server.summary()
        finally:
            handle.close()
    finally:
        close_monitor(monitor)
    return Bench(result, engine_summary, handle.server)


def report(bench: Bench, args) -> None:
    """Print the client summary as JSON and both sides as markdown tables;
    with ``--check``, exit non-zero where a gate fails."""
    from repro_torch.core import report as report_lib

    summary = bench.result.summary
    print(json.dumps(summary, indent=2, default=float))
    print("\n## Client-side steady state\n")
    print(report_lib.to_markdown(report_lib.serving_client_rows(summary)))
    print("\n## Engine-side (same run, via /metrics ledger)\n")
    print(report_lib.to_markdown(report_lib.serving_summary_rows(bench.engine_summary)))
    if args.check:
        _check(summary, args)


def _bench(mesh, args, front_end=False) -> int:
    """One rank of ``--tp``: rank 0 runs the benchmark and reports; the
    other ranks follow its engine's steps."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.sharding.partition import shard_model

    if mesh.rank == 0:
        bench = run(args, mesh)
        try:
            report(bench, args)
        finally:
            bench.server.engine.close()
        return 0
    model = shard_model(get_config(args.arch, smoke=args.smoke), mesh, args.seed)
    ServingEngine(model, max_batch=args.max_batch, max_len=args.max_len, seed=args.seed,
                  prefill_chunk=args.prefill_chunk, device=mesh.device, mesh=mesh,
                  cuda_graph=mesh.capturable).follow()
    return 0


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.tp < 1:
        ap.error("--tp takes an integer >= 1")
    if args.tp > 1:
        from repro_torch.launch.serve import refuse_tp, run_ranks, tp_backend

        refuse_tp(ap, args)
        return run_ranks(_bench, args, tp_backend(ap, args))
    report(run(args), args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
