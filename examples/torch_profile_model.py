"""Full profiling session of the PyTorch port (paper §2 end to end),
including the custom-model hook, the counterpart of overriding ELANA's
``_build_model_and_tokenizer``.

    PYTHONPATH=src python examples/torch_profile_model.py [--arch qwen1.5-0.5b]
        [--builder] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; measured mode draws the
full model there and the reduced config on the CPU.  ``--arch`` takes any
ported architecture, the MoE ones too (their size report splits active
from total parameters).
"""

import argparse
import json

import torch

from repro_torch.cli import power_reader
from repro_torch.configs import get_config
from repro_torch.core.profiler import Elana
from repro_torch.models import model as model_lib


def custom_builder(arch: str, smoke: bool, device: str):
    """Option B: your own model, ELANA unchanged.  ``build()`` returns any
    ``ModelConfig`` and a ``Model`` on the profiler's device, e.g. with
    weights you loaded or compressed; here the registry's config with
    weights drawn from the caller's own generator."""
    def build():
        cfg = get_config(arch, smoke=smoke)
        gen = torch.Generator(device=device).manual_seed(1)
        return cfg, model_lib.init(cfg, gen, device)
    return build


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--builder", action="store_true",
                    help="profile the model that custom_builder builds (option B)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    smoke = args.device == "cpu"

    if args.builder:
        # ---- option B: your own model, ELANA unchanged ------------------
        e = Elana(builder=custom_builder(args.arch, smoke, args.device), device=args.device)
    else:
        # ---- option A: registry model -----------------------------------
        e = Elana(args.arch, smoke=smoke, device=args.device)

    print("== size =="); print(e.size_report().fmt())
    print("\n== cache =="); print(e.cache_report(2, 256).fmt("MB"))

    reader = power_reader(None, args.device)  # NVML on the GPU, /proc/stat on the CPU
    print(f"\n== measured latency + energy ({type(reader).__name__}) ==")
    try:
        m = e.measure(batch=1, prompt_len=args.prompt_len, gen_len=args.gen_len,
                      iters=3, power_reader=reader)
    finally:
        reader.close()
    print(json.dumps(m, indent=2))

    print("\n== estimated on the paper's platforms and the H100 ==")
    full = Elana(args.arch, device=args.device)  # full config for the estimator
    for hw in ("a6000", "jetson-agx-thor", "jetson-orin-nano", "h100"):
        est = full.estimate(hardware=hw, batch=1, prompt_len=512, gen_len=512)
        print(f"{hw:18s} TTFT {est.ttft.latency_s*1e3:8.1f} ms  "
              f"TPOT {est.tpot.latency_s*1e3:7.2f} ms  "
              f"J/Tok {est.tpot.joules:6.2f}  [{est.tpot.bound}]")

    path = f"trace_{args.arch.replace('.', '_')}.json"
    s = full.trace(path, phase="decode", seq_len=1024)
    print(f"\nwrote {path} — {json.dumps(s, indent=2)}")


if __name__ == "__main__":
    main()
