"""Serving driver of the port: open-loop traffic against the
continuous-batching engine, with per-request energy attribution.  The
counterpart of ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch llama3.1-8b --cache-layout paged
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke --device cpu \
        --arrival-rate 4
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke --device cpu \
        --replay 0:8:4,0.05:16:4
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke --device cpu \
        --power-reader synthetic --http-port 8000
    python -m repro_torch.launch.serve --arch llama3.1-8b --cache-layout paged \
        --prefill-chunk 256 --prefix-cache --shared-prefix-len 448
    python -m repro_torch.launch.serve --arch llama3.1-8b --cache-layout paged \
        --preemption recompute --kv-num-blocks auto --speculative lookup \
        --spec-tokens 4 --lookup-friendly
    python -m repro_torch.launch.serve --arch llama3.1-8b --cache-layout paged --tp 2
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke --device cpu --tp 2
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --smoke --device cpu --tp 2

``--arrival-rate 0`` (the default) submits every request at the start;
otherwise arrivals are Poisson at that rate, replayed against the wall
clock by ``OpenLoopDriver``.  ``--replay t:plen:max_new,...`` replays an
explicit schedule instead, and ``--bursty`` waves of same-instant
arrivals.  ``--http-port`` serves the OpenAI-compatible HTTP API
(``serving/server.py``) until Ctrl-C instead of replaying a trace.  The
weights are random, drawn from ``--seed``.  Energy is read by
``--power-reader`` (NVML on the GPU by default, none on the CPU) and
split between requests by the tokens each emitted in every window.
Prints ``latency_summary()`` as JSON, then markdown tables of the latency
percentiles, the step economics and the requests.

``--tp N`` shards the model over N rank processes (``launch.mesh``): every
decoder (dense, MoE with E / N experts a rank, vision-prefix, RG-LRU and
xLSTM); a dim N does not divide is replicated.  An encoder-decoder model,
and query heads that would straddle two KV groups unevenly, are refused
before any rank starts (``sharding.rules.check_tp``).  NCCL with
one GPU per rank and CUDA-graph steps where N GPUs are visible;
on fewer GPUs gloo ranks that share them, whose steps run eagerly (pass
``--cuda-graph off``); on the CPU gloo ranks.  Rank 0 prints, serves HTTP
and reads the power; the other ranks follow its steps.  Ranks that share
one board or host are read by one monitor, so their energy is not split
per device.  Under ``--http-port`` only rank 0 answers Ctrl-C.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve random-weight requests on the port's engine and print "
                    "TTFT/TPOT/TTLT and energy per request")
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced (CPU-runnable) config variant")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len-dist", default="uniform",
                    choices=["fixed", "uniform", "lognormal"])
    ap.add_argument("--prompt-len-mean", type=float, default=24.0)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals/sec; 0 = submit all up front")
    ap.add_argument("--replay", default="",
                    help="deterministic schedule t:plen:max_new,... (overrides "
                         "--arrival-rate)")
    ap.add_argument("--bursty", action="store_true",
                    help="the bursty overcommit workload (waves of simultaneous arrivals) "
                         "instead of Poisson traffic: what --preemption recompute is for")
    ap.add_argument("--burst-size", type=int, default=4,
                    help="requests per wave of the --bursty trace")
    ap.add_argument("--burst-gap", type=float, default=0.25,
                    help="seconds between --bursty waves")
    ap.add_argument("--http-port", type=int, default=0,
                    help="serve over HTTP instead of replaying a trace: the OpenAI-compatible "
                         "server (POST /v1/completions, stream=true for server-sent events; "
                         "GET /v1/models, /metrics) on this port until Ctrl-C (0 = off; the "
                         "workload flags are ignored)")
    ap.add_argument("--http-host", default="127.0.0.1", help="bind address for --http-port")
    ap.add_argument("--cache-layout", default="contiguous", choices=["contiguous", "paged"],
                    help="KV layout: worst-case contiguous slots or a shared block "
                         "pool with per-slot block tables")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-num-blocks", default="0",
                    help="paged pool size in blocks; 0 = worst case, 'auto' = sized from the "
                         "trace (p95 sequence length x estimated concurrency, "
                         "cache.suggest_num_blocks; pair with --preemption recompute so a "
                         "bursty tail preempts instead of failing)")
    ap.add_argument("--preemption", default="off", choices=["off", "recompute"],
                    help="pool overcommit (paged only): 'off' reserves each request's worst "
                         "case at admission; 'recompute' reserves lazily, grows blocks as "
                         "decodes need them and, when the pool is dry, preempts the newest "
                         "request (never the head of line), re-admitting it later by "
                         "recomputing its prompt and emitted tokens")
    ap.add_argument("--power-reader", default=None,
                    choices=["nvml", "proc", "model", "synthetic", "none"],
                    help="power source for energy attribution (default: nvml on the "
                         "GPU, none on the CPU)")
    ap.add_argument("--cuda-graph", default="on", choices=["on", "off"],
                    help="replay the decode and unified steps from CUDA graphs (GPU "
                         "only; 'off' exists to compare the two)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: prefill prompts in chunks of this many tokens, "
                         "interleaved with decode steps (0 = whole-prompt admission); "
                         "bounds how long in-flight decodes stall on a new prompt")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="prompt tokens of chunk work per engine step (0 = one chunk; "
                         "at least --prefill-chunk); only with --prefill-chunk")
    ap.add_argument("--unified-step", default="on", choices=["on", "off"],
                    help="advance the chunks and decode every armed slot in one step "
                         "(needs --prefill-chunk > 0); 'off' runs one dispatch per chunk "
                         "plus the decode step")
    ap.add_argument("--pad-side", default="left", choices=["left", "right"],
                    help="prompt-bucket padding: 'right' keeps the prompt at the row's "
                         "start, so prompts sharing a prefix with suffixes of other "
                         "lengths share cached blocks (streams differ from 'left': the "
                         "positions shift)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="block-level prefix caching (paged layout, attention-only "
                         "models): share the resident blocks of a common prompt prefix "
                         "read-only and skip their prefill")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="a shared-prefix workload instead of independent prompts: each "
                         "request starts with one of --shared-prefixes fixed prompts of "
                         "this many tokens (0 = off)")
    ap.add_argument("--shared-prefixes", type=int, default=2,
                    help="distinct prefixes in the shared-prefix workload")
    ap.add_argument("--shared-suffix-len", type=int, default=16,
                    help="tokens appended to each shared prefix (fixed, so padded lengths "
                         "match); the --prompt-len-* flags are ignored then")
    ap.add_argument("--speculative", default="off", choices=["off", "lookup"],
                    help="speculative decoding: 'lookup' drafts each request's next tokens "
                         "from its own prompt and output (n-gram lookup, no draft model) and "
                         "verifies every window in one step; the streams equal 'off', only "
                         "the tokens per step change")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="most draft tokens per verify window with --speculative lookup (the "
                         "window scores k + 1 positions)")
    ap.add_argument("--lookup-friendly", action="store_true",
                    help="the self-similar workload speculation serves: each prompt is one "
                         "motif tiled, and greedy generation keeps cycling it")
    ap.add_argument("--motif-len", type=int, default=8,
                    help="motif tokens per --lookup-friendly prompt")
    ap.add_argument("--motif-repeats", type=int, default=4,
                    help="times each --lookup-friendly motif is tiled")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: shard heads, FFN hidden, experts, recurrent "
                         "widths and vocabulary over N processes (a dim N does not divide "
                         "replicated), with per-device KV and power ledgers (NCCL, one GPU "
                         "per rank; with fewer GPUs, or on the CPU, gloo ranks, eager "
                         "steps); every decoder: encoder-decoder models, and query heads "
                         "straddling two KV groups unevenly, are refused")
    return ap


def refuse_tp(ap, args) -> None:
    """``ap.error`` with ``sharding.rules.check_tp``'s reason where ``--tp``
    cannot shard ``--arch`` (an encoder, an uneven KV-group straddle),
    before any rank starts."""
    from repro_torch.configs import get_config
    from repro_torch.sharding.rules import check_tp

    try:
        check_tp(get_config(args.arch, smoke=args.smoke), args.tp)
    except ValueError as exc:
        ap.error(str(exc))


def tp_backend(ap, args):
    """The backend of ``--tp`` ranks on ``args.device`` (None: the mesh's
    default), refusing a CUDA graph that gloo ranks cannot capture."""
    import torch

    from repro_torch import resolve_device

    if torch.device(args.device).type != "cuda":
        return None
    resolve_device(args.device)  # raises where there is no GPU
    if torch.cuda.device_count() >= args.tp:
        return None
    if getattr(args, "cuda_graph", "off") == "on":
        ap.error(f"--tp {args.tp} on {torch.cuda.device_count()} GPU(s) runs gloo ranks that "
                 f"share them, whose collectives a CUDA graph cannot capture: pass "
                 f"--cuda-graph off")
    return "gloo"


def run_ranks(fn, args, backend, front_end=False):
    """``fn(mesh, args)`` on ``args.tp`` ranks; rank 0's result.  With a
    front end (``--http-port``) Ctrl-C reaches rank 0 only: this process
    and the other ranks ignore it while the ranks run."""
    import os
    import signal

    import torch

    from repro_torch.launch.mesh import spawn_tp

    # CPU ranks split the cores between them
    threads = (max(1, (os.cpu_count() or 1) // args.tp)
               if torch.device(args.device).type == "cpu" else 0)
    old = signal.signal(signal.SIGINT, signal.SIG_IGN) if front_end else None
    try:
        return spawn_tp(fn, args.tp, args.device, args, front_end, backend=backend,
                        threads=threads)[0]
    finally:
        if old is not None:
            signal.signal(signal.SIGINT, old)


def _parse_replay(text: str):
    rows = []
    for item in text.split(","):
        try:
            t, plen, max_new = item.split(":")
            rows.append((float(t), int(plen), int(max_new)))
        except ValueError:
            raise ValueError(f"bad --replay item {item!r}: expected t:plen:max_new")
    return rows


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.prefix_cache and args.cache_layout != "paged":
        ap.error("--prefix-cache requires --cache-layout paged")
    if args.preemption != "off" and args.cache_layout != "paged":
        ap.error("--preemption recompute requires --cache-layout paged")
    if args.kv_num_blocks != "auto":
        try:
            args.kv_num_blocks = int(args.kv_num_blocks)
        except ValueError:
            ap.error("--kv-num-blocks takes an integer or 'auto'")
        if args.kv_num_blocks < 0:
            ap.error("--kv-num-blocks takes an integer >= 0 or 'auto'")
    elif args.cache_layout != "paged":
        ap.error("--kv-num-blocks auto requires --cache-layout paged")
    if args.replay:
        try:
            _parse_replay(args.replay)
        except ValueError as e:
            ap.error(str(e))
    if args.tp < 1:
        ap.error("--tp takes an integer >= 1")
    if args.tp > 1:
        refuse_tp(ap, args)
        return run_ranks(_serve, args, tp_backend(ap, args), front_end=bool(args.http_port))
    return _serve(None, args)


def _serve(mesh, args, front_end=False) -> int:
    """The serving run on one rank (``mesh`` None without tensor parallelism):
    rank 0 makes the trace, the monitor and the output and drives the
    engine; the other ranks follow its steps."""
    import signal

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.energy import close_monitor, make_monitor
    from repro_torch.models import cache as cache_lib
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.workload import (LengthDist, WorkloadSpec, bursty_trace,
                                              estimate_concurrency, lookup_friendly_trace,
                                              poisson_trace, replay_trace,
                                              shared_prefix_trace)
    from repro_torch.sharding.partition import shard_model

    lead = mesh is None or mesh.rank == 0
    if front_end and lead:  # Ctrl-C stops the server on rank 0
        signal.signal(signal.SIGINT, signal.default_int_handler)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    plo = max(int(args.prompt_len_mean // 4), 1)
    phi = max(int(args.prompt_len_mean * 2), plo + 1)
    spec = WorkloadSpec(
        arrival_rate=args.arrival_rate, num_requests=args.requests,
        prompt_len=LengthDist(kind=args.prompt_len_dist, mean=args.prompt_len_mean,
                              low=plo, high=phi),
        output_len=LengthDist(kind="fixed", mean=args.max_new, low=1,
                              high=max(args.max_new, 1)),
        temperature=args.temperature, seed=args.seed)
    if args.replay:
        arrivals = replay_trace(_parse_replay(args.replay), cfg.vocab_size, seed=args.seed,
                                temperature=args.temperature, top_k=20)
    elif args.bursty:
        bursts = max(-(-args.requests // max(args.burst_size, 1)), 1)
        arrivals = bursty_trace(
            cfg.vocab_size, bursts=bursts, burst_size=args.burst_size, gap_s=args.burst_gap,
            prompt_len=max(int(args.prompt_len_mean), 1), max_new=args.max_new,
            seed=args.seed, temperature=args.temperature, top_k=20)[:args.requests]
    elif args.lookup_friendly:
        arrivals = lookup_friendly_trace(
            cfg.vocab_size, num_requests=args.requests, motif_len=args.motif_len,
            repeats=args.motif_repeats, max_new=args.max_new, arrival_rate=args.arrival_rate,
            seed=args.seed, temperature=args.temperature, top_k=20)
    elif args.shared_prefix_len > 0:
        arrivals = shared_prefix_trace(
            cfg.vocab_size, num_requests=args.requests, shared_prefix_len=args.shared_prefix_len,
            num_prefixes=args.shared_prefixes, suffix_len=args.shared_suffix_len,
            max_new=args.max_new, arrival_rate=args.arrival_rate, seed=args.seed,
            temperature=args.temperature, top_k=20)
    else:
        arrivals = poisson_trace(spec, cfg.vocab_size)

    kv_num_blocks = args.kv_num_blocks
    if kv_num_blocks == "auto":
        seq_lens = [len(a.prompt) + a.params.max_new_tokens for a in arrivals]
        kv_num_blocks = cache_lib.suggest_num_blocks(
            seq_lens, args.kv_block_size, args.max_len, args.max_batch,
            concurrency=estimate_concurrency(arrivals, args.max_batch))
        worst = cache_lib.default_num_blocks(args.max_batch, args.max_len, args.kv_block_size)
        if lead:
            print(f"# --kv-num-blocks auto -> {kv_num_blocks} blocks (worst case {worst}); "
                  f"pair with --preemption recompute to survive a bursty tail")

    monitor = None
    if lead:
        reader = args.power_reader or ("nvml" if device.type == "cuda" else "none")
        shared = mesh is not None and mesh.backend != "nccl"
        monitor = make_monitor(reader, args.tp, shared)
        if mesh is not None:
            print(f"# --tp {args.tp}: {mesh.describe()}"
                  + ("; per-device energy is not split: the ranks share one board or host"
                     if shared and monitor is not None else ""), flush=True)
    if mesh is None:
        model = model_lib.init(cfg, torch.Generator(device=device).manual_seed(args.seed),
                               device)
    else:
        model = shard_model(cfg, mesh, args.seed)
    engine = ServingEngine(model, max_batch=args.max_batch, max_len=args.max_len,
                           seed=args.seed, cache_layout=args.cache_layout,
                           kv_block_size=args.kv_block_size,
                           kv_num_blocks=kv_num_blocks, device=device,
                           cuda_graph=args.cuda_graph == "on",
                           prefill_chunk=args.prefill_chunk,
                           prefill_budget=args.prefill_budget,
                           unified_step=args.unified_step == "on", pad_side=args.pad_side,
                           prefix_cache=args.prefix_cache, preemption=args.preemption,
                           speculative=args.speculative, spec_tokens=args.spec_tokens,
                           mesh=mesh)
    if not lead:
        engine.follow()
        return 0
    try:
        return _lead(args, cfg, engine, monitor, arrivals)
    finally:
        close_monitor(monitor)
        engine.close()


def _lead(args, cfg, engine, monitor, arrivals) -> int:
    """Rank 0: drive the engine (the trace, or the HTTP server) and print."""
    import torch

    from repro_torch.core import report
    from repro_torch.serving.workload import OpenLoopDriver

    device = engine.device
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if args.http_port:
        return _serve_http(args, cfg, engine, monitor, device_name)
    if monitor is not None:
        engine.attach_monitor(monitor)
    with monitor or contextlib.nullcontext():
        finished = OpenLoopDriver(engine, arrivals).run()
    summary = engine.latency_summary()
    summary["device"] = device_name
    print(json.dumps(summary, indent=2))
    print("\n## Latency percentiles\n")
    print(report.to_markdown(report.serving_summary_rows(summary)))
    throughput = report.serving_throughput_rows(summary)
    if throughput:
        print("\n## Step economics\n")
        print(report.to_markdown(throughput))
    print("\n## Per-request (energy attributed per token window)\n")
    print(report.to_markdown(report.serving_request_rows(sorted(finished, key=lambda r: r.uid))))
    return 0


def _serve_http(args, cfg, engine, monitor, device_name) -> int:
    """``--http-port``: serve until Ctrl-C, then print the summary."""
    from repro_torch.core import report
    from repro_torch.serving.server import start_http_server

    if monitor is not None:
        engine.attach_monitor(monitor)
    with monitor or contextlib.nullcontext():
        handle = start_http_server(engine, host=args.http_host, port=args.http_port,
                                   model_name=cfg.name)
        print(f"# serving {cfg.name} at {handle.url} (POST /v1/completions; Ctrl-C to "
              f"stop)", flush=True)
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            handle.close()
    summary = handle.server.summary()
    summary["device"] = device_name
    print(json.dumps(summary, indent=2, default=float))
    print("\n## Latency percentiles\n")
    print(report.to_markdown(report.serving_summary_rows(summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
