"""The ``elana`` command line of the port (paper §1: "run a command from the
terminal without modifying the code"), the counterpart of ``repro/cli.py``.

    python -m repro_torch.cli archs
    python -m repro_torch.cli size    --arch llama3.1-8b
    python -m repro_torch.cli cache   --arch llama3.1-8b --batch 128 --seq-len 2048
    python -m repro_torch.cli latency --arch llama3.1-8b --prompt 512 --gen 32
    python -m repro_torch.cli energy  --arch llama3.1-8b --prompt 512 --gen 32
    python -m repro_torch.cli estimate --arch qwen2.5-7b --hardware h100 --prompt 512 --gen 512
    python -m repro_torch.cli trace   --arch llama3.1-8b --hardware h100 --out trace.json
    python -m repro_torch.cli report  --hardware h100

Every subcommand but ``archs`` runs on ``--device`` (``cuda`` by default,
and then it needs a GPU).  ``size``, ``cache``, ``estimate``, ``trace`` and
``report`` work from shapes alone (the ``meta`` device), so
``--device cpu`` runs them anywhere.  ``energy`` reads the GPU's power from
NVML; with ``--device cpu`` it reads the host CPU's from /proc/stat.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced (CPU-runnable) config variant")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--unit", default="GB", help="GB (SI, default) or GiB")


def _elana(args):
    from repro_torch.core.profiler import Elana

    return Elana(args.arch, smoke=args.smoke, device=args.device,
                 seed=getattr(args, "seed", 0))


def cmd_archs(args) -> int:
    from repro_torch.configs import NOT_PORTED, list_archs

    print("ported:")
    for a in list_archs():
        print(f"  {a}")
    print("not ported yet:")
    for a, family in NOT_PORTED.items():
        print(f"  {a} ({family})")
    return 0


def cmd_size(args) -> int:
    print(_elana(args).size_report().fmt(args.unit))
    return 0


def cmd_cache(args) -> int:
    print(_elana(args).cache_report(args.batch, args.seq_len).fmt(args.unit))
    return 0


def cmd_latency(args) -> int:
    out = _elana(args).measure(batch=args.batch, prompt_len=args.prompt,
                               gen_len=args.gen, iters=args.iters)
    print(json.dumps(out, indent=2))
    return 0


def cmd_energy(args) -> int:
    from repro_torch.core import energy
    from repro_torch.core.hardware import get_hardware

    if args.device == "cpu":
        hw = get_hardware("cpu")
        reader = energy.ProcStatReader(hw.idle_watts, hw.tdp_watts)
    else:
        reader = energy.NvmlReader()
    try:
        out = _elana(args).measure(batch=args.batch, prompt_len=args.prompt,
                                   gen_len=args.gen, iters=args.iters,
                                   power_reader=reader)
    finally:
        reader.close()
    print(json.dumps(out, indent=2))
    return 0


def cmd_estimate(args) -> int:
    from repro_torch.core import report

    est = _elana(args).estimate(
        hardware=args.hardware, n_devices=args.n_devices, mode=args.mode,
        batch=args.batch, prompt_len=args.prompt, gen_len=args.gen,
    )
    print(report.to_markdown(report.table3_rows([est])))
    for ph in (est.ttft, est.tpot):
        print(f"  {ph.name}: bound={ph.bound} compute={ph.compute_s*1e3:.2f}ms "
              f"memory={ph.memory_s*1e3:.2f}ms coll={ph.collective_s*1e3:.2f}ms "
              f"avg_watts={ph.avg_watts:.0f}")
    return 0


def cmd_trace(args) -> int:
    summary = _elana(args).trace(
        args.out, hardware=args.hardware, phase=args.phase,
        batch=args.batch, seq_len=args.seq_len,
    )
    print(f"wrote {args.out} (open at https://ui.perfetto.dev)")
    print(json.dumps(summary, indent=2))
    return 0


def cmd_report(args) -> int:
    from repro_torch.configs import NOT_PORTED, PAPER
    from repro_torch.core import report
    from repro_torch.core.profiler import Elana

    archs = args.archs.split(",") if args.archs else PAPER
    sizes, caches, ests = [], {}, []
    for a in archs:
        if a in NOT_PORTED:
            continue
        e = Elana(a, device=args.device)
        sizes.append(e.size_report())
        caches[e.cfg.name] = {
            (1, 1024): e.cache_report(1, 1024),
            (128, 1024): e.cache_report(128, 1024),
            (128, 2048): e.cache_report(128, 2048),
        }
        ests.append(e.estimate(hardware=args.hardware, batch=1,
                               prompt_len=512, gen_len=512))
    print("## Table 2: model + cache size")
    print(report.to_markdown(report.table2_rows(sizes, caches)))
    print()
    print(f"## Table 3-style: latency/energy on {args.hardware} (estimator)")
    print(report.to_markdown(report.table3_rows(ests)))
    skipped = [f"{a} ({NOT_PORTED[a]})" for a in archs if a in NOT_PORTED]
    if skipped:
        print(f"not ported yet, left out: {', '.join(skipped)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="elana",
        description="ELANA on PyTorch: energy & latency analyzer for LLMs (NVIDIA GPUs)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("archs").set_defaults(fn=cmd_archs)

    p = sub.add_parser("size")
    _add_common(p)
    p.set_defaults(fn=cmd_size)

    p = sub.add_parser("cache")
    _add_common(p)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=1024)
    p.set_defaults(fn=cmd_cache)

    for name, fn in (("latency", cmd_latency), ("energy", cmd_energy)):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--batch", type=int, default=1)
        p.add_argument("--prompt", type=int, default=64)
        p.add_argument("--gen", type=int, default=16)
        p.add_argument("--iters", type=int, default=5)
        p.add_argument("--seed", type=int, default=0)
        p.set_defaults(fn=fn)

    p = sub.add_parser("estimate")
    _add_common(p)
    p.add_argument("--hardware", default="h100")
    p.add_argument("--n-devices", type=int, default=1)
    p.add_argument("--mode", default="tp", choices=["tp", "dp", "naive_pp"])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--prompt", type=int, default=512)
    p.add_argument("--gen", type=int, default=512)
    p.set_defaults(fn=cmd_estimate)

    p = sub.add_parser("trace")
    _add_common(p)
    p.add_argument("--hardware", default="h100")
    p.add_argument("--phase", default="decode", choices=["decode", "prefill"])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--out", default="elana_trace.json")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("report")
    p.add_argument("--archs", default="",
                   help="comma-separated; default: the paper's models")
    p.add_argument("--hardware", default="h100")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_report)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
