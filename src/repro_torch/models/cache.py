"""Decode-time KV caches, contiguous layout: the counterpart of the
contiguous and ring-buffer part of ``repro/models/cache.py``.

A layer's entry is a dict with the reference's leaves: ``k``/``v``
``(batch, L, H, D)``, ``pos`` ``(batch, L)`` int32 absolute key positions
(-1 = unfilled) and ``ring`` (a 0-d int32 flag, 1 when the entry is a
sliding-window ring shorter than the context), so the byte counts of the
two packages agree.  Unlike the reference's pure functions, the fill and
update functions write into the entry in place and return it: a decode
step then moves one token's K/V instead of copying the whole cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def init_attn_cache(batch: int, max_len: int, n_kv: int, head_dim: int, dtype,
                    device, window: int = 0) -> Dict[str, torch.Tensor]:
    length = min(window, max_len) if window > 0 else max_len
    ring = 1 if (0 < window < max_len) else 0
    return {
        "k": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
        "ring": torch.full((), ring, dtype=torch.int32, device=device),
    }


def fill_attn_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor) -> Dict:
    """Write a full prefill's K/V (B, S, H, D) into the cache.

    A ring keeps only the last ``L`` timesteps.  ``positions`` is (B, S)
    with identical rows; row 0 gives the slot bookkeeping.  Every slot is
    written (unfilled ones with position -1), so the entry holds this
    prompt only.
    """
    S = k.shape[1]
    L = cache["k"].shape[1]
    pos_row = positions[0].to(torch.int32)
    if S >= L:
        k_tail, v_tail, p_tail = k[:, S - L:], v[:, S - L:], pos_row[S - L:]
    else:
        pad = L - S
        k_tail = F.pad(k, (0, 0, 0, 0, 0, pad))
        v_tail = F.pad(v, (0, 0, 0, 0, 0, pad))
        p_tail = F.pad(pos_row, (0, pad), value=-1)
    slots = torch.where(p_tail >= 0, p_tail % L,
                        torch.arange(L, device=p_tail.device) % L).long()
    cache["k"][:, slots] = k_tail.to(cache["k"].dtype)
    cache["v"][:, slots] = v_tail.to(cache["v"].dtype)
    cache["pos"][:, slots] = p_tail[None, :]
    return cache


def update_attn_cache(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                      positions: torch.Tensor,
                      update_mask: Optional[torch.Tensor] = None) -> Dict:
    """Write one decoded token's K/V (B, 1, H, D) at per-row ``positions``
    (B,).  ``update_mask`` (B,) bool turns masked-off rows into no-op
    writes (their current cache content is written back)."""
    B, L = cache["pos"].shape
    positions = positions.to(torch.int32).expand(B)
    slot = (positions % L).long()
    rows = torch.arange(B, device=slot.device)
    k_w, v_w, p_w = k_new[:, 0], v_new[:, 0], positions
    if update_mask is not None:
        m = update_mask.reshape(B, 1, 1)
        k_w = torch.where(m, k_w, cache["k"][rows, slot])
        v_w = torch.where(m, v_w, cache["v"][rows, slot])
        p_w = torch.where(update_mask, p_w, cache["pos"][rows, slot])
    cache["k"][rows, slot] = k_w.to(cache["k"].dtype)
    cache["v"][rows, slot] = v_w.to(cache["v"].dtype)
    cache["pos"][rows, slot] = p_w
    return cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device) -> Dict[str, torch.Tensor]:
    if kind == "ffn":
        return {}
    if kind == "attn":
        return init_attn_cache(batch, max_len, cfg.num_kv_heads,
                               cfg.resolved_head_dim, dtype, device)
    raise NotImplementedError(f"no cache for block kind {kind!r} in the port yet")


def cache_bytes(cache: List[Dict[str, torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for entry in cache for t in entry.values())
