"""Plain PyTorch versions of the decode-attention kernels, the counterparts
of ``repro/kernels/decode_attention/ref.py``.

``decode_attention``: one new query token per sequence attends over a
(possibly ring-buffered) contiguous KV cache.  Slots with k_position == -1
are unfilled and masked; window masking uses absolute positions, so ring
buffers work unchanged.

``paged_decode_attention``: the same over a block pool, gathered through a
per-sequence block table; gathered index j is absolute position j.

A row with no valid key returns 0, as the kernels do.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def decode_attention(
    q: torch.Tensor,            # (B, 1, Hq, D)
    k_cache: torch.Tensor,      # (B, L, Hkv, D)
    v_cache: torch.Tensor,      # (B, L, Hkv, D)
    *,
    q_positions: torch.Tensor,  # (B, 1)
    k_positions: torch.Tensor,  # (B, L)
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, S, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(), k_cache.float()) / math.sqrt(D)
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    valid = (k_positions >= 0) & (k_positions <= q_positions)  # (B, L)
    if window > 0:
        valid = valid & (q_positions - k_positions < window)
    valid = valid[:, None, None, None, :]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * valid.any(dim=-1, keepdim=True)
    o = torch.einsum("bhgst,bthd->bshgd", probs.to(v_cache.dtype), v_cache)
    return o.reshape(B, S, Hq, D)


def paged_decode_attention(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_pool: torch.Tensor,        # (N, bs, Hkv, D) global block pool
    v_pool: torch.Tensor,        # (N, bs, Hkv, D)
    *,
    block_tables: torch.Tensor,  # (B, max_blocks) int32 pool indices
    q_positions: torch.Tensor,   # (B, 1)
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, nb = block_tables.shape
    bs = k_pool.shape[1]
    L = nb * bs
    idx = block_tables.long()
    k = k_pool[idx].reshape(B, L, *k_pool.shape[2:])
    v = v_pool[idx].reshape(B, L, *v_pool.shape[2:])
    k_positions = torch.arange(L, dtype=torch.int32,
                               device=q.device)[None].expand(B, L)
    return decode_attention(q, k, v, q_positions=q_positions,
                            k_positions=k_positions, window=window,
                            softcap=softcap)
