"""End-to-end training with the PyTorch port: a ~100M-parameter
llama-family model trained on synthetic data through the port's driver,
with checkpoints, preemption safety, straggler tracking and ELANA energy
accounting (NVML on the GPU, /proc/stat on the CPU).

    PYTHONPATH=src python examples/torch_train_100m.py              # full run
    PYTHONPATH=src python examples/torch_train_100m.py --tiny --device cpu

Runs on the GPU unless ``--device cpu`` is given.  ``--tiny`` trains a
reduced model for 30 steps.
"""

import argparse
import json
import sys
import tempfile
import types

from repro_torch import configs, resolve_device
from repro_torch.launch.train import build_argparser, train
from repro_torch.models.config import ModelConfig

# ~100M params: 12 layers, d=768, llama-style (tied embeddings)
MODEL_100M = ModelConfig(
    name="llama-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
    d_ff=2048, vocab_size=32_000, tie_embeddings=True,
    dtype="float32", param_dtype="float32",
)


def register(cfg: ModelConfig) -> None:
    """Make ``cfg`` the registry's ``llama-100m``, so the generic driver
    finds it by ``--arch``."""
    mod = types.ModuleType("repro_torch.configs.llama_100m")
    mod.CONFIG = mod.SMOKE = cfg
    sys.modules[mod.__name__] = mod
    configs._MODULES[cfg.name] = "llama_100m"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true", help="reduced model + 30 steps (smoke/CI)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="where to checkpoint and resume from (default: a new temporary "
                         "directory, so no earlier run is resumed)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raises where there is no GPU, before any directory is made
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="elana_train_100m_")

    cfg = MODEL_100M
    if args.tiny:
        cfg = cfg.replace(num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                          d_ff=256, vocab_size=512)
    register(cfg)
    steps = 30 if args.tiny else args.steps
    out = train(build_argparser().parse_args([
        "--arch", cfg.name, "--device", args.device, "--steps", str(steps),
        "--batch", "8", "--seq-len", "64" if args.tiny else "128",
        "--lr", "3e-3", "--warmup", "20",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--energy", "--log-every", "10",
    ]))
    print(json.dumps(out, indent=2))
    assert out["loss_last"] < out["loss_first"], "loss did not decrease!"
    print(f"\nloss {out['loss_first']:.3f} -> {out['loss_last']:.3f} over "
          f"{out['steps']} steps; checkpoints in {args.ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
