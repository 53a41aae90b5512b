"""Plain PyTorch version of the flash-attention kernel (GQA, causal,
windowed, soft-capped), the counterpart of
``repro/kernels/flash_attention/ref.py``.

One difference from the reference oracle: a query row with no valid key
returns 0, as the kernels (Pallas and CUDA) do, where the reference's
softmax over an all-masked row returns the mean of V.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def attention(
    q: torch.Tensor,            # (B, S, Hq, D)
    k: torch.Tensor,            # (B, T, Hkv, D)
    v: torch.Tensor,            # (B, T, Hkv, D)
    *,
    q_positions: torch.Tensor,  # (B, S) int32
    k_positions: torch.Tensor,  # (B, T) int32; -1 marks unfilled slots
    causal: bool,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float()) / math.sqrt(D)
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    qp = q_positions[:, None, None, :, None]
    kp = k_positions[:, None, None, None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (qp >= kp)
    if window > 0:
        valid = valid & (qp - kp < window)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * valid.any(dim=-1, keepdim=True)
    o = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype), v)
    return o.reshape(B, S, Hq, D)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    causal: bool,
    window: int = 0,
    softcap: float = 0.0,
    block_q: int = 1024,
) -> torch.Tensor:
    """``attention`` over blocks of ``block_q`` queries at a time, so the
    fp32 scores take block_q x T memory instead of S x T.  Exact: each
    query row's softmax sees every key."""
    outs = [
        attention(q[:, i:i + block_q], k, v,
                  q_positions=q_positions[:, i:i + block_q],
                  k_positions=k_positions, causal=causal, window=window,
                  softcap=softcap)
        for i in range(0, q.shape[1], block_q)
    ]
    return torch.cat(outs, dim=1)
