"""Serving driver of the port: closed-loop traffic (every request submitted
at the start) against the continuous-batching engine, with per-request
energy attribution.  The counterpart of ``repro/launch/serve.py`` for the
flags of the engine the port has.

    python -m repro_torch.launch.serve --arch llama3.1-8b --cache-layout paged
    python -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke --device cpu

The weights are random, drawn from ``--seed``.  Energy is read by
``--power-reader`` (NVML on the GPU by default, none on the CPU) and
split between requests by the tokens each emitted in every window.
Prints ``latency_summary()`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys


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
    ap.add_argument("--cache-layout", default="contiguous", choices=["contiguous", "paged"],
                    help="KV layout: worst-case contiguous slots or a shared block "
                         "pool with per-slot block tables")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-num-blocks", type=int, default=0,
                    help="paged pool size in blocks; 0 = worst case")
    ap.add_argument("--power-reader", default=None, choices=["nvml", "synthetic", "none"],
                    help="power source for energy attribution (default: nvml on the "
                         "GPU, none on the CPU)")
    ap.add_argument("--cuda-graph", default="on", choices=["on", "off"],
                    help="replay the decode step from a CUDA graph (GPU only; 'off' "
                         "exists to compare the two)")
    return ap


def _make_monitor(kind: str):
    from repro_torch.core.energy import NvmlReader, PowerMonitor, SyntheticReader

    if kind == "none":
        return None
    reader = NvmlReader() if kind == "nvml" else SyntheticReader(lambda t: 42.0)
    return PowerMonitor(reader)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.workload import LengthDist, WorkloadSpec, poisson_trace

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    plo = max(int(args.prompt_len_mean // 4), 1)
    phi = max(int(args.prompt_len_mean * 2), plo + 1)
    spec = WorkloadSpec(
        arrival_rate=0.0, num_requests=args.requests,
        prompt_len=LengthDist(kind=args.prompt_len_dist, mean=args.prompt_len_mean,
                              low=plo, high=phi),
        output_len=LengthDist(kind="fixed", mean=args.max_new, low=1,
                              high=max(args.max_new, 1)),
        temperature=args.temperature, seed=args.seed)
    arrivals = poisson_trace(spec, cfg.vocab_size)

    reader = args.power_reader or ("nvml" if device.type == "cuda" else "none")
    monitor = _make_monitor(reader)
    model = model_lib.init(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    engine = ServingEngine(model, max_batch=args.max_batch, max_len=args.max_len,
                           seed=args.seed, cache_layout=args.cache_layout,
                           kv_block_size=args.kv_block_size,
                           kv_num_blocks=args.kv_num_blocks, device=device,
                           cuda_graph=args.cuda_graph == "on")
    for a in arrivals:
        engine.submit(a.prompt, a.params)
    try:
        if monitor is not None:
            engine.attach_monitor(monitor)
            with monitor:
                engine.run()
        else:
            engine.run()
    finally:
        if monitor is not None:
            monitor.reader.close()
    summary = engine.latency_summary()
    summary["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu")
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
