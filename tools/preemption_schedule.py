#!/usr/bin/env python3
"""The schedule of ``chip_smoke.py``'s preemption phase, run on the CPU:

    python3 tools/preemption_schedule.py

The phase serves ``chip_smoke.serve_arrivals`` (24 requests at t = 0, EOS
off) on llama3.1-8b with the pool cut to 129 blocks of 16 and
``preemption="recompute"``, chunked through the unified step.  With EOS
off every request emits exactly its budget, so which request is
preempted when, and how many tokens are recomputed, depend on the
prompt and output lengths alone, not on the weights or the tokens drawn.
This script serves the same trace (generated at llama3.1-8b's vocabulary,
so the lengths are the same draws, the tokens taken modulo the smoke
vocabulary) with the same engine settings on tinyllama-1.1b's smoke
config on the CPU, and prints one JSON line with ``preemptions``,
``recompute_tokens``, the steps, the first preemption of each preempted
request, the pool's peak and the ``--kv-num-blocks auto`` suggestion for
the trace: the values the card's run must reproduce.  Imports nothing of
JAX or of the ``repro`` package.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine

    arrivals = chip_smoke.serve_arrivals(get_config(chip_smoke.ARCH), chip_smoke.SERVE_REQUESTS[
        chip_smoke.ARCH])
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(model, **chip_smoke.SERVE, **chip_smoke.CHUNKED, device="cpu",
                        **chip_smoke.PREEMPT)
    first = {}
    preempt = eng._preempt

    def recorded(slot):
        req = eng.slots[slot]
        first.setdefault(req.uid, len(req.output_tokens) + int(eng._ring_n[slot]))
        preempt(slot)

    eng._preempt = recorded
    for a in arrivals:
        eng.submit(a.prompt % cfg.vocab_size, a.params)
    finished = eng.run()
    assert len(finished) == len(arrivals)
    assert all(len(r.output_tokens) == a.params.max_new_tokens
               for r, a in zip(sorted(finished, key=lambda r: r.uid), arrivals))
    print(json.dumps({
        "preemptions": eng.preemptions, "recompute_tokens": eng.recompute_tokens,
        "steps": eng._steps_done, "unified_steps": eng.chunk_forwards,
        "decode_only_steps": eng.decode_forwards - eng.chunk_forwards,
        "peak_blocks_in_use": eng.peak_blocks_in_use,
        "num_blocks": eng.num_blocks, "dispatches_per_step_max": max(eng._dispatch_samples),
        "first_preemption_at_token": first,
        "suggested_kv_num_blocks": chip_smoke.suggested_blocks(arrivals)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
