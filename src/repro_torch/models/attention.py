"""Grouped-query attention for prefill and decode over contiguous caches
and paged block pools, the counterpart of ``repro/models/attention.py``.

Projections are plain matrix products; the attention itself goes through
``repro_torch.kernels.dispatch``, which hands CUDA tensors to the Hopper
kernels.  Layouts are the reference's: q (B, S, Hq, D), k/v (B, S, Hkv, D),
wq (d, Hq, hd), wo (Hq, hd, d).

A tensor-parallel shard (``shards`` ranks, the mesh in ``p.tp``) holds its
Hq / tp query heads where tp divides them, else every head (the attention
replicated whole, its output not a partial sum); and its Hkv / tp KV heads
where tp divides those, else every KV head.  With the query heads split
and the KV heads whole, rank r's query heads ``[r·Hq/tp, (r+1)·Hq/tp)``
read one KV head, ``r·(Hq/tp) // G`` (``sharding.rules.check_tp`` refuses
a rank whose heads straddle two groups): the prompt's K2 and the decode
step's K3 read only it, from the fresh K/V or from the contiguous cache's
L slices gathered over the ranks (``cache.read_kv``), and K4 reads it in
place from the replicated pool (its ``q_head0``).  Under grad a split
attention's input and any whole K/V weights its ranks read in part are
``collectives.copy``'d, so their gradients sum over the ranks; the
encoder's attention and a decoder's cross attention shard alike
(training).

A decode step under the serve rules (``layers.ServeLayout``) takes the
whole batch's input as the rank's slice of ``d``: its q/k/v products are
summed over the slices in one all-reduce (``layers.project_in``), the
biases added after; the rank writes and attends over the rows whose
cache it holds (``serve.rows``), and their outputs are gathered over
data into the whole batch before the out projection, whose output is
the rank's slice of ``d``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    ServeLayout, apply_rope, init_normal_, matmul_fp32, new_param, project_in,
)
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import divides, local_size


class Attention(nn.Module):
    """Attention parameters, the counterpart of the reference's
    ``make_attention`` (QKV biases when ``cfg.qkv_bias``, never on an
    encoder-decoder block's ``cross`` attention); a shard of ``shards``
    ranks holds its query and KV heads where tp divides them."""

    def __init__(self, cfg: ModelConfig, dtype, device, cross: bool = False,
                 shards: int = 1):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        self.group = h // kv  # the model's G
        # a shard's output is one rank's partial sum, kept in fp32 for the
        # sum over the ranks, where its query heads are split
        self.partial = divides(shards, h)
        self.kv_split = divides(shards, kv)
        self.tp = None  # the mesh of a tensor-parallel shard (set by ``Model``)
        h, kv = local_size(h, shards), local_size(kv, shards)
        self.wq = new_param((d, h, hd), dtype, device)
        self.wk = new_param((d, kv, hd), dtype, device)
        self.wv = new_param((d, kv, hd), dtype, device)
        self.wo = new_param((h, hd, d), dtype, device)
        if cfg.qkv_bias and not cross:
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


def _kv_read(p: Attention) -> Tuple[slice, int]:
    """The rank's KV heads its query heads read (a slice of the heads it
    holds) and its first query head: the one KV head of a rank whose query
    heads are split over whole KV heads, else every KV head it holds."""
    if p.tp is None or p.kv_split or not p.partial:
        return slice(None), 0
    q0 = p.tp.rank * p.wq.shape[1]
    kv0 = q0 // p.group
    return slice(kv0, kv0 + 1), q0


def _heads(y: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]):
    """A product ``y`` (B, S, h·hd) of ``w`` (d, h, hd) as (B, S, h, hd),
    plus the bias."""
    y = y.reshape(*y.shape[:2], *w.shape[1:])
    return y if b is None else y + b


def _project(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             serve: Optional[ServeLayout] = None):
    """"bsd,dhk->bshk" (+ bias) as one matrix product."""
    return _project_all(x, (w,), (b,), serve)[0]


def _project_all(x: torch.Tensor, ws, bs, serve: Optional[ServeLayout] = None):
    """``_project`` of ``x`` by each weight of ``ws`` with its bias of
    ``bs``: on a serve layout one all-reduce for them all, each bias added
    after it."""
    ys = project_in(x, [w.reshape(w.shape[0], -1) for w in ws], serve)
    return [_heads(y, w, b) for y, w, b in zip(ys, ws, bs)]


def _local_in(p: Attention, x: torch.Tensor) -> torch.Tensor:
    """A replicated input of the rank's heads (``collectives.copy`` where
    the query heads are split)."""
    return collectives.copy(x, p.tp) if p.partial else x


def _kv_leaf(p: Attention, w: torch.Tensor) -> torch.Tensor:
    """A K/V weight or bias: whole on every rank where tp splits the query
    heads but not the KV heads, each rank reading its heads' KV head of it
    (``collectives.copy``)."""
    return collectives.copy(w, p.tp) if p.partial and not p.kv_split else w


def _project_qkv(p: Attention, x: torch.Tensor, serve: Optional[ServeLayout] = None):
    bias = hasattr(p, "bq")
    ws = (p.wq, _kv_leaf(p, p.wk), _kv_leaf(p, p.wv))
    bs = (p.bq, _kv_leaf(p, p.bk), _kv_leaf(p, p.bv)) if bias else (None,) * 3
    return _project_all(_local_in(p, x), ws, bs, serve)


def _own_rows(serve: Optional[ServeLayout], *ts):
    """Each of ``ts`` cut to the rows whose cache the rank holds under the
    serve rules (all of them otherwise; None stays None)."""
    if serve is None or serve.rows is None:
        return ts
    return tuple(None if t is None else t[serve.rows] for t in ts)


def _whole_rows(serve: Optional[ServeLayout], o: torch.Tensor) -> torch.Tensor:
    """The attention's output of the rank's rows gathered over data into
    the whole batch's, under the serve rules."""
    if serve is None or serve.rows is None:
        return o
    return collectives.gather(o, 0, serve.data)


def _out_proj(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """"bshk,hkd->bsd"; a shard's partial sum in fp32."""
    B, S = o.shape[:2]
    mm = matmul_fp32 if p.partial else torch.matmul
    return mm(o.reshape(B, S, -1), p.wo.reshape(-1, p.wo.shape[-1]))


def _self_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                    rope, causal: bool, window: int):
    """q/k/v of ``x``, rotated, and K2 over the sequence itself (the KV
    heads the rank's queries read): returns (the attention's output before
    the out projection, k, v)."""
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    heads, _ = _kv_read(p)
    o = dispatch.flash_attention(
        q.contiguous(), k[:, :, heads].contiguous(), v[:, :, heads].contiguous(),
        q_positions=positions, k_positions=positions,
        causal=causal, window=window, softcap=cfg.logit_softcap,
    )
    return o, k, v


def apply_attention_train(
    p: Attention,
    x: torch.Tensor,           # (B, S, d)
    cfg: ModelConfig,
    positions: torch.Tensor,   # (B, S) int32, contiguous
    *,
    rope,                      # layers.rope_tables(positions, ...)
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention over the whole sequence with no cache, through K2: the
    training forward (causal, with the layer's window) and, with
    ``causal=False``, the encoder's unmasked self-attention, as the
    reference's ``apply_attention_train``.  Differentiable: K2's backward
    is its plain version's."""
    return _out_proj(p, _self_attention(p, x, cfg, positions, rope, causal, window)[0])


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
    o, k, v = _self_attention(p, x, cfg, positions, rope, True, window)
    if "kp" in kv_cache:
        kv_cache = cache_lib.fill_paged_cache(kv_cache, k, v, block_tables)
    else:
        kv_cache = cache_lib.fill_attn_cache(kv_cache, k, v, positions, p.tp)
    return _out_proj(p, o), kv_cache


def apply_attention_prefill_chunk(
    p: Attention,
    x: torch.Tensor,           # (B, C, d) one prompt chunk
    cfg: ModelConfig,
    positions: torch.Tensor,   # (B, C) int32 absolute positions start..start+C-1
    kv_cache: Dict,
    *,
    rope,                      # layers.rope_tables(positions, ...)
    window: int = 0,
    block_tables: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    overwrite_from: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Chunked prefill: the chunk attends to the earlier chunks in the
    cache plus itself (causally), then its K/V stays for the next chunks
    and for decode.

    A contiguous or ring cache attends over (cache before the append ++
    chunk), so a chunk longer than a window still sees its own early keys
    (the append would evict them from the ring); a paged cache appends
    first and attends over the gathered pool, where index is position.
    ``valid`` (B, C) bool marks each row's real tokens when ragged chunks
    are packed into one width (the unified step): pad columns write
    nothing (paged: to the garbage block, at positions past every query;
    contiguous: their key positions are -1), and their outputs are garbage
    the caller drops.

    ``overwrite_from`` (B,) int32 hides the cached contiguous entries at
    positions >= the row's value.  The speculative verify step writes
    again positions its last window wrote (a rejected draft suffix is
    never rolled back): those stale entries share the chunk's positions,
    and the contiguous read over cache ++ chunk would attend to them and
    count the overlap twice.  The paged branch needs no mask: it appends
    before it gathers, and stale positions past the window lie past every
    query."""
    q, k, v = _project_qkv(p, x)
    q = apply_rope(q, rope).contiguous()
    k = apply_rope(k, rope)
    heads, _ = _kv_read(p)
    if "kp" in kv_cache:
        kv_cache = cache_lib.append_paged_cache(kv_cache, k, v, positions, block_tables,
                                                valid)
        k_all, v_all, k_pos = cache_lib.gather_paged_kv(kv_cache, block_tables)
        k_all, v_all = k_all[:, :, heads].contiguous(), v_all[:, :, heads].contiguous()
    else:
        k_c, v_c = cache_lib.read_kv(kv_cache, heads, p.tp)
        k_all = torch.cat([k_c.to(k.dtype), k[:, :, heads]], dim=1)
        v_all = torch.cat([v_c.to(v.dtype), v[:, :, heads]], dim=1)
        chunk_pos = positions if valid is None else torch.where(valid, positions, -1)
        cache_pos = kv_cache["pos"]
        if overwrite_from is not None:
            cache_pos = torch.where(cache_pos >= overwrite_from[:, None], -1, cache_pos)
        k_pos = torch.cat([cache_pos, chunk_pos.to(torch.int32)], dim=1)
    o = dispatch.flash_attention(
        q, k_all, v_all, q_positions=positions, k_positions=k_pos,
        causal=True, window=window, softcap=cfg.logit_softcap,
    )
    if "kp" not in kv_cache:
        kv_cache = cache_lib.append_attn_cache(kv_cache, k, v, positions, valid, p.tp)
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
    serve: Optional[ServeLayout] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One token's attention: its K/V written at ``positions`` into the
    cache, K3 (contiguous or ring) or K4 (paged) over it.  Under the serve
    rules (``serve``) only the rows whose cache the rank holds are written
    and attended."""
    q, k_new, v_new = _project_qkv(p, x, serve)
    q = apply_rope(q, rope)
    k_new = apply_rope(k_new, rope)
    q, k_new, v_new, positions, update_mask = _own_rows(serve, q, k_new, v_new, positions,
                                                        update_mask)
    pos_b = positions[:, None]
    heads, q_head0 = _kv_read(p)
    if "kp" in kv_cache:  # paged: append through the table, attend on the pool
        kv_cache = cache_lib.update_paged_cache(kv_cache, k_new, v_new, positions,
                                                block_tables, update_mask)
        o = dispatch.paged_decode_attention(
            q.contiguous(), kv_cache["kp"], kv_cache["vp"],
            block_tables=block_tables, q_positions=pos_b.contiguous(),
            window=window, softcap=cfg.logit_softcap, q_head0=q_head0, group=p.group,
        )
        return _out_proj(p, o), kv_cache
    kv_cache = cache_lib.update_attn_cache(kv_cache, k_new, v_new, positions,
                                           update_mask, p.tp)
    k_c, v_c = cache_lib.read_kv(kv_cache, heads, p.tp)
    o = dispatch.decode_attention(
        q.contiguous(), k_c, v_c,
        q_positions=pos_b.contiguous(), k_positions=kv_cache["pos"],
        window=window, softcap=cfg.logit_softcap,
    )
    return _out_proj(p, _whole_rows(serve, o)), kv_cache


# -- cross attention (encoder-decoder) ---------------------------------------
#
# The reference attends over every row of the encoder memory with an
# unmasked softmax (``attention.sdpa`` with every key at position 0).  Here
# a prompt or chunk goes through K2 without the causal mask and a decode
# step through K3: no key of the memory is masked by position, so any
# non-negative positions serve, the queries' own and the memory's frame
# indices.  The memory's K/V stay in the entry's first T rows of
# ``cross_k``/``cross_v`` (``cache.fill_cross_cache``), whose ``cross_pos``
# marks them 0 and the rows past T -1, so a decode step attends over the
# T rows the reference attends over whatever the entry's length.

def apply_cross_attention_seq(
    p: Attention,
    x: torch.Tensor,           # (B, S, d) decoder states
    positions: torch.Tensor,   # (B, S) int32, the states' positions
    memory: torch.Tensor,      # (B, T, d) encoder output
    mem_positions: torch.Tensor,  # (B, T) int32 frame indices
    kv_cache: Optional[Dict] = None,
) -> torch.Tensor:
    """A prompt or chunk's cross attention over the encoder ``memory``:
    its K/V projected once, written into the entry for the decode steps
    (the reference's ``precompute_cross_kv``) where one is given (the
    training forward has none), and attended by K2 (a shard's heads: the
    KV heads its query heads read)."""
    q = _project(_local_in(p, x), p.wq, None)
    memory = _local_in(p, memory)
    k, v = _project(memory, _kv_leaf(p, p.wk), None), _project(memory, _kv_leaf(p, p.wv), None)
    if kv_cache is not None:
        cache_lib.fill_cross_cache(kv_cache, k, v)
    heads, _ = _kv_read(p)
    o = dispatch.flash_attention(q.contiguous(), k[:, :, heads].contiguous(),
                                 v[:, :, heads].contiguous(),
                                 q_positions=positions, k_positions=mem_positions,
                                 causal=False)
    return _out_proj(p, o)


def apply_cross_attention_decode(
    p: Attention,
    x: torch.Tensor,           # (B, 1, d)
    positions: torch.Tensor,   # (B,) int32, the new token's positions
    kv_cache: Dict,
    serve: Optional[ServeLayout] = None,
) -> torch.Tensor:
    """One decode step's cross attention over the memory in the entry,
    through K3 (under the serve rules, the rows whose memory the rank
    holds, each masked by its own ``cross_pos``)."""
    q, positions = _own_rows(serve, _project(x, p.wq, None, serve), positions)
    o = dispatch.decode_attention(q.contiguous(), kv_cache["cross_k"], kv_cache["cross_v"],
                                  q_positions=positions[:, None].contiguous(),
                                  k_positions=kv_cache["cross_pos"])
    return _out_proj(p, _whole_rows(serve, o))
