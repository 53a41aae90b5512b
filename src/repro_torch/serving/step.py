"""The serving engine's decode step and its unified prefill + decode step,
the counterpart of ``repro/serving/step.py``.

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

plus ``block_tables`` (B, blocks_per_slot) int32 in the paged layout, and
with speculation (``spec_k > 0``) one (B, spec_k + 1) int32 tensor the
host fills with one copy before every verify step: ``draft`` (its first
spec_k columns, each slot's drafted tokens) and ``draft_len`` (its last,
how many of them are valid).

``make_spec_decode_step`` replaces the decode step when the engine
speculates: one multi-token forward (``model.prefill_chunk`` over each
slot's window [last token, draft...], every column's logits) and the
acceptance chain (``sampling.verify_slots_keyed``), which emits 1 + the
accepted draft tokens per slot.  Its packed output is (B, 2 (spec_k + 1)
+ 1) int32: emitted tokens, emission mask, finished flag.

``make_engine_step`` is the unified step: one chunk of every prefilling
slot's prompt, packed slot-aligned at a static width W, then the decode
step over the chunk-updated cache.  Its input is one (B, W + 5) int32
chunk buffer (``pack_chunk``), so the host uploads it with one copy:

  tokens       columns 0..W-1, the row's next prompt tokens
  start        absolute position of column 0
  length       valid columns (0: the slot has no chunk this step)
  temperature  the request's sampling temperature (float32 bits)
  top_k        its top-k
  key          its random-stream key (int32 bits)

Each row's first token is drawn inside the step from the chunk's
last-valid-position logits, as draw 0 of the request's stream (the draw
depends only on key and index, so it equals the host's ``sample`` on the
same logits); the host keeps it only for rows whose prompt ended.
With speculation the decode half is the verify body, and the first
tokens ride as one more column of its (B, 2 (spec_k + 1) + 1) output.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.serving.sampling import (SamplingParams, sample_slots_keyed,
                                          verify_slots_keyed)

FIELDS = ("tokens", "positions", "active", "remaining", "temperature", "top_k", "eos",
          "key", "count")
CHUNK_FIELDS = ("start", "length", "temperature", "top_k", "key")


def init_slot_state(max_batch: int, max_blocks: int = 0, device="cpu",
                    spec_k: int = 0) -> Dict[str, torch.Tensor]:
    packed = torch.zeros((max_batch, len(FIELDS)), dtype=torch.int32, device=device)
    state = {name: packed[:, i] for i, name in enumerate(FIELDS)}
    state["temperature"] = state["temperature"].view(torch.float32)
    state["eos"].fill_(-1)
    state["packed"] = packed
    if max_blocks > 0:
        state["block_tables"] = torch.zeros((max_batch, max_blocks), dtype=torch.int32,
                                            device=device)
    if spec_k > 0:
        drafts = torch.zeros((max_batch, spec_k + 1), dtype=torch.int32, device=device)
        state.update(drafts=drafts, draft=drafts[:, :spec_k], draft_len=drafts[:, spec_k])
    return state


def write_slot(state: Dict[str, torch.Tensor], slot: int, *, token: int, position: int,
               remaining: int, params: SamplingParams, active: bool, key: int,
               count: int) -> None:
    """Arm (or disarm) one slot's row with one host-to-device copy."""
    row = np.array([token, position, int(active), remaining, 0, params.top_k,
                    params.eos_token, np.int64(key).astype(np.int32), count], np.int32)
    row[FIELDS.index("temperature")] = np.float32(params.temperature).view(np.int32)
    state["packed"][slot].copy_(torch.from_numpy(row))


def pack_chunk(buf: np.ndarray, slot: int, tokens: np.ndarray, start: int,
               params: SamplingParams, key: int) -> None:
    """Write one slot's row of a host chunk buffer (B, W + 5) int32 (zeros
    elsewhere: rows without a chunk)."""
    W = buf.shape[1] - len(CHUNK_FIELDS)
    buf[slot, :len(tokens)] = tokens
    buf[slot, W:] = [start, len(tokens), np.float32(params.temperature).view(np.int32),
                     params.top_k, np.int64(key).astype(np.int32)]


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


def _spec_verify_body(model, max_len: int, k_max: int, state: Dict[str, torch.Tensor],
                      cache) -> torch.Tensor:
    """Score every slot's window [last emitted token, draft...] in one
    forward, a ragged (B, spec_k + 1) chunk at the slot's next write
    position (length draft_len + 1 for an active slot, 0 otherwise, so
    idle and prefilling slots write nothing), then run the acceptance
    chain.  The window's K/V is written where it is computed: accepted
    positions hold what step-at-a-time decoding would have written, and a
    rejected suffix is written again by the next window before it is read
    (``overwrite_from`` hides it from a contiguous read meanwhile; a paged
    read masks it causally)."""
    active = state["active"] != 0
    window = torch.cat([state["tokens"][:, None], state["draft"]], dim=1)
    lengths = torch.where(active, state["draft_len"] + 1, 0)
    positions = state["positions"].contiguous()
    logits, _ = model.prefill_chunk(window, cache, positions,
                                    block_tables=state.get("block_tables"), lengths=lengths,
                                    overwrite_from=positions, all_logits=True)
    res = verify_slots_keyed(
        logits, state["draft"], state["draft_len"], state["temperature"], state["top_k"],
        state["key"].long() & 0xFFFFFFFF, state["count"].long(), active=active,
        tokens0=state["tokens"], positions=state["positions"], remaining=state["remaining"],
        eos=state["eos"], max_len=max_len, k_max=k_max)
    state["tokens"].copy_(res["last_token"])
    state["positions"].copy_(res["positions"])
    state["remaining"].copy_(res["remaining"])
    state["count"].copy_(res["counts"])
    state["active"].copy_(res["active"].int())
    return torch.cat([res["tokens"], res["emit"].int(), res["done"].int()[:, None]], dim=1)


def make_spec_decode_step(model, max_len: int, k_max: int = 64) -> Callable:
    """``step(state, cache) -> out``, the verify step that replaces the
    decode step when the engine speculates; ``out`` is (B, 2 (k + 1) + 1)
    int32: the tokens each slot emitted, in stream order, the emission
    mask (a prefix of the window) and the finished flag."""

    def step(state: Dict[str, torch.Tensor], cache) -> torch.Tensor:
        return _spec_verify_body(model, max_len, k_max, state, cache)

    return step


def make_engine_step(model, max_len: int, k_max: int = 64, spec_k: int = 0) -> Callable:
    """The unified step ``step(state, chunk, cache) -> out``: the chunk
    advance (``model.prefill_chunk`` over the packed rows; rows of length
    0 write nothing), then ``_decode_sample_body`` over the chunk-updated
    cache, in the order of the per-chunk path, so the streams are the
    same.  A prefilling slot is inactive in ``state``, so the decode
    half's ``update_mask`` keeps it off the chunk's fresh K/V and state.
    ``out`` is (4, B) int32: the decode step's three rows, then each
    row's first token drawn from its chunk's logits.  With ``spec_k > 0``
    the verify body takes the decode body's place, and ``out`` is its
    (B, 2 (spec_k + 1) + 1) output with the first tokens as one more
    column: still one step, so speculation keeps the dispatch bound."""

    def step(state: Dict[str, torch.Tensor], chunk: torch.Tensor, cache) -> torch.Tensor:
        W = chunk.shape[1] - len(CHUNK_FIELDS)
        start, length, temperature, top_k, key = (chunk[:, W + i]
                                                  for i in range(len(CHUNK_FIELDS)))
        logits, _ = model.prefill_chunk(chunk[:, :W], cache, start,
                                        block_tables=state.get("block_tables"),
                                        lengths=length)
        first = sample_slots_keyed(logits, temperature.view(torch.float32), top_k,
                                   key.long() & 0xFFFFFFFF, torch.zeros_like(key, dtype=torch.int64),
                                   k_max=k_max).int()
        if spec_k > 0:
            out = _spec_verify_body(model, max_len, k_max, state, cache)
            return torch.cat([out, first[:, None]], dim=1)
        out = _decode_sample_body(model, max_len, k_max, state, cache)
        return torch.cat([out, first[None]])

    return step
