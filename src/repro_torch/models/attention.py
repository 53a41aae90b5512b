"""Grouped-query attention for prefill and decode over contiguous caches
and paged block pools, the counterpart of ``repro/models/attention.py``.

Projections are plain matrix products; the attention itself goes through
``repro_torch.kernels.dispatch``, which hands CUDA tensors to the Hopper
kernels.  Layouts are the reference's: q (B, S, Hq, D), k/v (B, S, Hkv, D),
wq (d, Hq, hd), wo (Hq, hd, d).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, init_normal_, new_param


class Attention(nn.Module):
    """Attention parameters, the counterpart of the reference's
    ``make_attention`` (QKV biases when ``cfg.qkv_bias``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        self.wq = new_param((d, h, hd), dtype, device)
        self.wk = new_param((d, kv, hd), dtype, device)
        self.wv = new_param((d, kv, hd), dtype, device)
        self.wo = new_param((h, hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = new_param((h, hd), dtype, device)
            self.bk = new_param((kv, hd), dtype, device)
            self.bv = new_param((kv, hd), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.wq, gen)
        init_normal_(self.wk, gen)
        init_normal_(self.wv, gen)
        h, hd = self.wo.shape[:2]
        init_normal_(self.wo, gen, scale=1.0 / math.sqrt(h * hd))
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()


def _project(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """"bsd,dhk->bshk" (+ bias) as one matrix product."""
    B, S, d = x.shape
    y = torch.matmul(x, w.reshape(d, -1)).reshape(B, S, *w.shape[1:])
    return y if b is None else y + b


def _project_qkv(p: Attention, x: torch.Tensor):
    bias = hasattr(p, "bq")
    return (_project(x, p.wq, p.bq if bias else None),
            _project(x, p.wk, p.bk if bias else None),
            _project(x, p.wv, p.bv if bias else None))


def _out_proj(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """"bshk,hkd->bsd"."""
    B, S = o.shape[:2]
    return torch.matmul(o.reshape(B, S, -1), p.wo.reshape(-1, p.wo.shape[-1]))


def apply_attention_prefill(
    p: Attention,
    x: torch.Tensor,           # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,   # (B, S) int32, contiguous
    kv_cache: Dict,
    *,
    rope,                      # layers.rope_tables(positions, ...)
    window: int = 0,
    block_tables: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Causal attention over the prompt; returns output + filled KV cache.
    The attention does not depend on the layout; only the cache write does:
    a paged entry (``kp`` in the dict) takes the prompt's K/V into the pool
    blocks that ``block_tables`` names."""
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    o = dispatch.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        q_positions=positions, k_positions=positions,
        causal=True, window=window, softcap=cfg.logit_softcap,
    )
    if "kp" in kv_cache:
        kv_cache = cache_lib.fill_paged_cache(kv_cache, k, v, block_tables)
    else:
        kv_cache = cache_lib.fill_attn_cache(kv_cache, k, v, positions)
    return _out_proj(p, o), kv_cache


def apply_attention_decode(
    p: Attention,
    x: torch.Tensor,           # (B, 1, d)
    cfg: ModelConfig,
    positions: torch.Tensor,   # (B,) int32: index of the new token
    kv_cache: Dict,
    *,
    rope,                      # layers.rope_tables(positions[:, None], ...)
    window: int = 0,
    block_tables: Optional[torch.Tensor] = None,
    update_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    pos_b = positions[:, None]
    q, k_new, v_new = _project_qkv(p, x)
    q = apply_rope(q, rope)
    k_new = apply_rope(k_new, rope)
    if "kp" in kv_cache:  # paged: append through the table, attend on the pool
        kv_cache = cache_lib.update_paged_cache(kv_cache, k_new, v_new, positions,
                                                block_tables, update_mask)
        o = dispatch.paged_decode_attention(
            q.contiguous(), kv_cache["kp"], kv_cache["vp"],
            block_tables=block_tables, q_positions=pos_b.contiguous(),
            window=window, softcap=cfg.logit_softcap,
        )
        return _out_proj(p, o), kv_cache
    kv_cache = cache_lib.update_attn_cache(kv_cache, k_new, v_new, positions,
                                           update_mask)
    o = dispatch.decode_attention(
        q.contiguous(), kv_cache["k"], kv_cache["v"],
        q_positions=pos_b.contiguous(), k_positions=kv_cache["pos"],
        window=window, softcap=cfg.logit_softcap,
    )
    return _out_proj(p, o), kv_cache
