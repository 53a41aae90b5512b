"""Quickstart: the ELANA workflow of the PyTorch port in ten lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the GPU unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.core.profiler import Elana


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # Any registered architecture (see `elana archs`); size, cache, estimate
    # and trace work from shapes alone, no weights are drawn.
    e = Elana("llama3.1-8b", device=args.device)

    print(e.size_report().fmt())                       # §2.2 model size
    print()
    print(e.cache_report(batch=128, seq_len=2048).fmt())  # §2.2 KV cache
    print()

    # §2.3/2.4 estimator mode: latency + energy on a target platform
    est = e.estimate(hardware="a6000", batch=1, prompt_len=512, gen_len=512)
    print(f"A6000 bsize=1 L=512+512:  TTFT {est.ttft.latency_s*1e3:.1f} ms "
          f"({est.ttft.joules:.1f} J)  TPOT {est.tpot.latency_s*1e3:.2f} ms "
          f"({est.tpot.joules:.2f} J/tok)  [{est.tpot.bound}-bound]")

    est = e.estimate(hardware="h100", n_devices=8, batch=8,
                     prompt_len=2048, gen_len=512)
    print(f"H100 x8 bsize=8:          TTFT {est.ttft.latency_s*1e3:.1f} ms   "
          f"TPOT {est.tpot.latency_s*1e3:.2f} ms  [{est.tpot.bound}-bound]")

    # §2.5 kernel-level timeline for Perfetto
    summary = e.trace("quickstart_trace.json", hardware="h100", phase="decode",
                      seq_len=2048)
    print(f"\nwrote quickstart_trace.json (open at https://ui.perfetto.dev) — "
          f"{summary['memory_bound_frac']*100:.0f}% of decode time is memory-bound")

    # Measured mode draws weights and times them: the full model on the
    # GPU, the reduced config on the CPU.
    smoke = args.device == "cpu"
    m = Elana("qwen1.5-0.5b", smoke=smoke, device=args.device).measure(
        batch=1, prompt_len=32, gen_len=8)
    print(f"\nmeasured ({'reduced ' if smoke else ''}qwen1.5-0.5b on {args.device}): "
          f"TTFT {m['ttft_ms']:.1f} ms, TPOT {m['tpot_ms']:.1f} ms")


if __name__ == "__main__":
    main()
