#!/usr/bin/env python3
"""Probe one tree of the PyTorch port on one NVIDIA GPU, so that two trees
(a change and its parent) can be compared in one run on one card:

    python3 tools/k1_probe.py --src PATH/TO/TREE/src

Prints one JSON line with
  * the host time per eager call (µs) of the K1 RMSNorm wrapper, and of
    its fused residual-add mode where the tree has one, at the decode
    shapes (1, 4096) and (8, 4096) and the prefill shape (512, 4096) bf16:
    ``chip_smoke.host_us``, calls enqueued behind a device spin so the
    device never holds the host back;
  * the device kernels that a prefill of 512 tokens and a decode step
    launch, and their device time (torch.profiler, each call in a window
    of its own: 2 prefills, 4 steps), for llama3.1-8b and recurrentgemma-2b
    at full width with seeded random weights.  A decode step's count
    includes one ``pos.add_`` kernel.

Imports nothing of JAX or of the ``repro`` package.  Exits non-zero where
there is no CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import host_us  # noqa: E402  (puts this checkout's src on the path)


def k1_host(dev):
    import torch

    from repro_torch.kernels.rmsnorm import ops

    out = {}
    for rows in (1, 8, 512):
        x = torch.randn(rows, 4096, device=dev, dtype=torch.bfloat16)
        s = torch.zeros(4096, device=dev, dtype=torch.bfloat16)
        out[f"rmsnorm ({rows},4096)"] = host_us(lambda: ops.rmsnorm(x, s, 1e-6))
        if hasattr(ops, "add_rmsnorm"):
            out[f"add_rmsnorm ({rows},4096)"] = host_us(lambda: ops.add_rmsnorm(x, x, s, 1e-6))
    return out


def device_kernels(arch, dev, prompt=512, steps=4):
    """Device kernels (memory copies and sets aside) and their device ms in
    each of 2 prefills and of ``steps`` decode steps, each step profiled in
    a window of its own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import init

    cfg = get_config(arch)
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cache = model.init_cache(1, prompt + steps + 2)
    logits, _ = model.prefill({"tokens": tokens}, cache)  # warm-up
    tok = logits.argmax(-1, keepdim=True)
    pos = torch.full((1,), prompt, dtype=torch.int32, device=dev)
    model.decode_step(tok, pos, cache)
    out = {"prefill": [], "decode_step": []}
    calls = [("prefill", lambda: model.prefill({"tokens": tokens}, cache))] * 2 + \
        [("decode_step", lambda: (pos.add_(1), model.decode_step(tok, pos, cache)))] * steps
    for name, fn in calls:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not e.key.startswith(("Memcpy", "Memset"))]
        out[name].append({"kernels": sum(e.count for e in evts),
                          "device_ms": sum(e.device_time_total for e in evts) / 1e3})
    del model, cache
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    args = ap.parse_args()
    sys.path.insert(0, args.src)  # ahead of this checkout's src
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    res = {"src": args.src, "device": torch.cuda.get_device_name(0),
           "host_us": k1_host(dev)}
    for arch in ("llama3.1-8b", "recurrentgemma-2b"):
        res[arch] = device_kernels(arch, dev)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
