"""Plain PyTorch versions of the decode-attention kernels, the counterparts
of ``repro/kernels/decode_attention/ref.py``.

``decode_attention``: one new query token per sequence attends over a
(possibly ring-buffered) contiguous KV cache.  Slots with k_position == -1
are unfilled and masked; window masking uses absolute positions, so ring
buffers work unchanged.

``paged_decode_attention``: the same over a block pool, gathered through a
per-sequence block table; gathered index j is absolute position j.

``decode_attention_split`` and ``paged_decode_attention_split``: the two
computed chunk by chunk and merged as the split-KV kernels do, the plain
statement of their merge algebra (for tests and ``chip_smoke.py``, which
hold the kernels to it at the chunks ``ops.split_plan`` picks; not for the
model).

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


def decode_attention_split(
    q: torch.Tensor,            # (B, 1, Hq, D)
    k_cache: torch.Tensor,      # (B, L, Hkv, D)
    v_cache: torch.Tensor,      # (B, L, Hkv, D)
    *,
    q_positions: torch.Tensor,  # (B, 1)
    k_positions: torch.Tensor,  # (B, L)
    window: int = 0,
    softcap: float = 0.0,
    chunk: int,
) -> torch.Tensor:
    """Each chunk of ``chunk`` slots gives its running max m, sum l and
    unnormalised output acc (m = NEG_INF, l = acc = 0 where it sees no
    key); the chunks merge as sum(exp(m_i - m) acc_i) / sum(exp(m_i - m)
    l_i), with m the largest m_i and the sum clamped at 1e-30.  fp32."""
    B, S, Hq, D = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D).float()
    valid = (k_positions >= 0) & (k_positions <= q_positions)  # (B, L)
    if window > 0:
        valid = valid & (q_positions - k_positions < window)
    parts = []
    for c0 in range(0, L, chunk):
        kc, vc = k_cache[:, c0:c0 + chunk].float(), v_cache[:, c0:c0 + chunk].float()
        s = torch.einsum("bshgd,bthd->bhgst", qg, kc) / math.sqrt(D)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        vis = valid[:, None, None, None, c0:c0 + chunk]
        s = torch.where(vis, s, -math.inf)
        m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
        p = torch.exp(s - m)
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum("bhgst,bthd->bhgsd", p, vc)))
    m = torch.stack([mi for mi, _, _ in parts]).amax(0)
    w = [torch.exp(mi - m) for mi, _, _ in parts]
    num = sum(wi * acc for wi, (_, _, acc) in zip(w, parts))
    den = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    o = num / den.clamp_min(1e-30)                        # (B, Hkv, G, S, D)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def _gather_pool(k_pool, v_pool, block_tables):
    """K and V of each row gathered through its table, (B, nb * bs, Hkv,
    D), and their positions: gathered index j is absolute position j."""
    B, nb = block_tables.shape
    L = nb * k_pool.shape[1]
    idx = block_tables.long()
    k = k_pool[idx].reshape(B, L, *k_pool.shape[2:])
    v = v_pool[idx].reshape(B, L, *v_pool.shape[2:])
    k_positions = torch.arange(L, dtype=torch.int32,
                               device=k_pool.device)[None].expand(B, L)
    return k, v, k_positions


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
    k, v, k_positions = _gather_pool(k_pool, v_pool, block_tables)
    return decode_attention(q, k, v, q_positions=q_positions,
                            k_positions=k_positions, window=window,
                            softcap=softcap)


def paged_decode_attention_split(
    q: torch.Tensor,             # (B, 1, Hq, D)
    k_pool: torch.Tensor,        # (N, bs, Hkv, D)
    v_pool: torch.Tensor,        # (N, bs, Hkv, D)
    *,
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    q_positions: torch.Tensor,   # (B, 1)
    window: int = 0,
    softcap: float = 0.0,
    chunk: int,
) -> torch.Tensor:
    """``paged_decode_attention`` with its positions cut into chunks of
    ``chunk`` (position j in chunk j // chunk, whatever pool block holds
    it), each chunk's partial merged as in ``decode_attention_split``."""
    k, v, k_positions = _gather_pool(k_pool, v_pool, block_tables)
    return decode_attention_split(q, k, v, q_positions=q_positions,
                                  k_positions=k_positions, window=window,
                                  softcap=softcap, chunk=chunk)
