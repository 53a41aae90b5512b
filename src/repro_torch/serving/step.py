"""The serving engine's decode step, the counterpart of
``repro/serving/step.py``.

``make_decode_sample_step`` fuses the decode forward pass, per-slot
sampling, position and budget bookkeeping and finish detection into one
function of the slot state and the cache.  It writes the new state into
the state tensors in place and returns a packed (3, B) int32 tensor, the
only thing the host reads back each step.  Its shapes never change (idle
slots are masked, not removed) and it never waits for the device, so the
engine captures it once in a CUDA graph and replays it every step.

The slot state is one (B, F) int32 tensor, one row per slot, so the host
arms a slot with one copy; ``init_slot_state`` hands out a named view of
each column (``temperature`` viewed as float32):

  tokens       next input token
  positions    next cache write position
  active       1 while the slot serves a live request
  remaining    new-token budget left
  temperature  sampling temperature (<= 0: greedy)
  top_k        top-k (0: no filter)
  eos          EOS id (-1: never)
  key          the request's random-stream key (``sampling.request_key``,
               stored as its int32 bits)
  count        index of the next draw in that stream: 1 + tokens emitted
               by the step so far (draw 0 is the first token's)

plus ``block_tables`` (B, blocks_per_slot) int32 in the paged layout.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.serving.sampling import SamplingParams, sample_slots_keyed

FIELDS = ("tokens", "positions", "active", "remaining", "temperature", "top_k", "eos",
          "key", "count")


def init_slot_state(max_batch: int, max_blocks: int = 0,
                    device="cpu") -> Dict[str, torch.Tensor]:
    packed = torch.zeros((max_batch, len(FIELDS)), dtype=torch.int32, device=device)
    state = {name: packed[:, i] for i, name in enumerate(FIELDS)}
    state["temperature"] = state["temperature"].view(torch.float32)
    state["eos"].fill_(-1)
    state["packed"] = packed
    if max_blocks > 0:
        state["block_tables"] = torch.zeros((max_batch, max_blocks), dtype=torch.int32,
                                            device=device)
    return state


def write_slot(state: Dict[str, torch.Tensor], slot: int, *, token: int, position: int,
               remaining: int, params: SamplingParams, active: bool, key: int,
               count: int) -> None:
    """Arm (or disarm) one slot's row with one host-to-device copy."""
    row = np.array([token, position, int(active), remaining, 0, params.top_k,
                    params.eos_token, np.int64(key).astype(np.int32), count], np.int32)
    row[FIELDS.index("temperature")] = np.float32(params.temperature).view(np.int32)
    state["packed"][slot].copy_(torch.from_numpy(row))


def invalidate_slot(state: Dict[str, torch.Tensor], slot: int, *,
                    garbage_block: int = 0) -> None:
    """Retire one slot between steps: inactive (its cache writes become
    no-ops), no budget, and in the paged layout its whole table row back
    at the garbage block, so its frozen idle writes never land in a block
    that was freed or handed to another request."""
    state["active"][slot] = 0
    state["remaining"][slot] = 0
    if "block_tables" in state:
        state["block_tables"][slot] = garbage_block


def make_decode_sample_step(model, max_len: int, k_max: int = 64) -> Callable:
    """``step(state, cache) -> out`` with ``out`` a (3, B) int32 tensor:

      out[0] — token emitted this step per slot (the frozen token of idle slots)
      out[1] — 1 where the slot finished on this step (EOS / budget / length cap)
      out[2] — 1 where the slot was active and therefore emitted out[0]
    """

    def step(state: Dict[str, torch.Tensor], cache) -> torch.Tensor:
        return _decode_sample_body(model, max_len, k_max, state, cache)

    return step


def _decode_sample_body(model, max_len: int, k_max: int, state: Dict[str, torch.Tensor],
                        cache) -> torch.Tensor:
    active = state["active"] != 0
    logits, _ = model.decode_step(state["tokens"][:, None], state["positions"], cache,
                                  block_tables=state.get("block_tables"),
                                  update_mask=active)
    keys = state["key"].long() & 0xFFFFFFFF
    tok = sample_slots_keyed(logits, state["temperature"], state["top_k"], keys,
                             state["count"].long(), k_max=k_max).int()

    act_i = active.int()
    tok = torch.where(active, tok, state["tokens"])
    positions = state["positions"] + act_i
    remaining = state["remaining"] - act_i
    hit_eos = (state["eos"] >= 0) & (tok == state["eos"])
    done = active & (hit_eos | (remaining <= 0) | (positions >= max_len - 1))

    state["tokens"].copy_(tok)
    state["positions"].copy_(positions)
    state["remaining"].copy_(remaining)
    state["count"].add_(act_i)
    state["active"].copy_((active & ~done).int())
    return torch.stack([tok, done.int(), act_i])
