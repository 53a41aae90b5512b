"""The ``elana`` command line of the port (paper §1: "run a command from the
terminal without modifying the code"), the counterpart of ``repro/cli.py``.

    python -m repro_torch.cli archs
    python -m repro_torch.cli size    --arch llama3.1-8b
    python -m repro_torch.cli cache   --arch llama3.1-8b --batch 128 --seq-len 2048
    python -m repro_torch.cli latency --arch llama3.1-8b --prompt 512 --gen 32
    python -m repro_torch.cli energy  --arch llama3.1-8b --prompt 512 --gen 32

Every subcommand but ``archs`` runs on ``--device`` (``cuda`` by default,
and then it needs a GPU).  ``energy`` reads the GPU's power from NVML.
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
    from repro_torch.core.energy import NvmlReader

    reader = NvmlReader()
    try:
        out = _elana(args).measure(batch=args.batch, prompt_len=args.prompt,
                                   gen_len=args.gen, iters=args.iters,
                                   power_reader=reader)
    finally:
        reader.close()
    print(json.dumps(out, indent=2))
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
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
