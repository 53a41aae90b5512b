"""Batched serving with the PyTorch port: submit a mixed batch of requests
to the engine, stream them through slot-based continuous batching, report
ELANA metrics.

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given: the full tinyllama-1.1b
there (decode step replayed from a CUDA graph), the reduced config on the
CPU.
"""

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampling import SamplingParams


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)   # raises where there is no GPU
    cfg = get_config("tinyllama-1.1b", smoke=device.type == "cpu")
    model = model_lib.init(cfg, torch.Generator(device=device).manual_seed(0), device)
    engine = ServingEngine(model, max_batch=4, max_len=128, prompt_bucket=16,
                           device=device)

    rng = np.random.default_rng(0)
    print("submitting 10 requests (prompt lengths 4..40, 8-24 new tokens)")
    for i in range(10):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 40)))
        engine.submit(prompt, SamplingParams(
            temperature=0.7 if i % 2 else 0.0,   # mixed greedy/sampled
            top_k=20, max_new_tokens=int(rng.integers(8, 24))))

    finished = engine.run()
    print(f"finished {len(finished)} requests")
    for r in finished[:3]:
        print(f"  req {r.uid}: prompt {len(r.prompt)} toks -> "
              f"{len(r.output_tokens)} new, TTFT {r.ttft_s*1e3:.0f} ms, "
              f"TPOT {r.tpot_s*1e3:.0f} ms")
    print("\nELANA request metrics:")
    print(json.dumps(engine.latency_summary(), indent=2))


if __name__ == "__main__":
    main()
