"""The decoder, the counterpart of ``repro/models/model.py`` for the block
kinds ``attn``, ``local_attn`` (sliding window over a ring cache), ``ffn``
and ``rglru`` (Griffin's recurrent block).

The reference stacks each repetition of ``cfg.block_pattern`` on a leading
axis and scans over it; here the layers are a plain ``nn.ModuleList`` run
in order (``bridge.params_from_jax`` unstacks the reference's groups).

Entry points:
  * ``init(cfg, generator, device)`` — a model with random weights at the
    reference initializer's scales.
  * ``Model.init_cache``  — one cache entry per layer.
  * ``Model.prefill``     — the prompt; fills the cache, returns the last
    position's logits.
  * ``Model.decode_step`` — one token against the cache (the TPOT step).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import cache as cache_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Embedding, Norm, add_norm, embed_tokens, rope_tables, unembed,
)
from repro_torch.models.mlp import MLP, apply_mlp

SUPPORTED_BLOCKS = ("attn", "local_attn", "ffn", "rglru")
ATTN_BLOCKS = ("attn", "local_attn")

Cache = List[Dict[str, torch.Tensor]]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, dtype, device):
        super().__init__()
        if kind not in SUPPORTED_BLOCKS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"(the port runs {SUPPORTED_BLOCKS})")
        if cfg.is_moe or cfg.is_encdec:
            raise NotImplementedError(f"{cfg.name}: MoE and enc-dec are not ported yet")
        self.kind = kind
        d = cfg.d_model
        if kind in ATTN_BLOCKS:
            self.norm1 = Norm(d, dtype, device)
            self.attn = attn_lib.Attention(cfg, dtype, device)
            if not cfg.parallel_block:  # one shared pre-norm (Cohere/GPT-J style)
                self.norm2 = Norm(d, dtype, device)
        elif kind == "rglru":
            self.norm1 = Norm(d, dtype, device)
            self.rec = rec_lib.RGLRU(cfg, dtype, device)
            self.norm2 = Norm(d, dtype, device)
        else:
            self.norm = Norm(d, dtype, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.mlp_gated, dtype, device)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "local_attn" else 0


def _write_state(entry: Dict, new: Dict, update_mask: Optional[torch.Tensor] = None) -> None:
    """Write a recurrent layer's new state into its cache entry in place,
    so the tensors a CUDA graph captured stay the ones it reads.  Rows
    masked off by ``update_mask`` keep their old state, as the reference's
    ``_gate_entry`` freezes them."""
    for leaf, t in new.items():
        if update_mask is not None:
            m = update_mask.reshape((-1,) + (1,) * (t.dim() - 1))
            t = torch.where(m, t, entry[leaf])
        entry[leaf].copy_(t)


# Each block takes the residual stream ``x`` and the branch output ``r`` not
# yet added to it (None before the first block), and returns the new pair.
# The add is folded into the next norm (``add_norm``, K1's fused mode), so
# every norm but the first block's is one launch for the add and the norm.
# A cross-attention block would fold its ``a`` into ``norm_c`` the same way.
Residual = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _apply_rglru_block(p: Block, cfg: ModelConfig, x: torch.Tensor,
                       r: Optional[torch.Tensor], entry: Dict,
                       update_mask: Optional[torch.Tensor] = None) -> Residual:
    """norm1 -> RG-LRU from the entry's state -> residual -> norm2 -> MLP.
    The scan starts from the state in ``entry`` (zeros in a fresh cache)."""
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
    y, state = rec_lib.apply_rglru_seq(p.rec, h, cfg, entry)
    _write_state(entry, state, update_mask)
    x, h = add_norm(p.norm2, x, y, cfg.norm_eps)
    return x, apply_mlp(p.mlp, h, cfg.mlp_act)


def _mlp_branch(p: Block, cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor,
                a: torch.Tensor) -> Residual:
    """An attention block after its attention output ``a``: the MLP branch,
    left pending.  A parallel block's MLP reads the shared pre-norm ``h``
    and adds ``a`` first, as the reference adds ``(x + a) + m``."""
    if cfg.parallel_block:
        return x + a, apply_mlp(p.mlp, h, cfg.mlp_act)
    x, h = add_norm(p.norm2, x, a, cfg.norm_eps)
    return x, apply_mlp(p.mlp, h, cfg.mlp_act)


def _apply_block_seq(p: Block, cfg: ModelConfig, x: torch.Tensor,
                     r: Optional[torch.Tensor], positions: torch.Tensor, rope, entry: Dict,
                     block_tables: Optional[torch.Tensor]) -> Residual:
    if p.kind == "rglru":
        return _apply_rglru_block(p, cfg, x, r, entry)
    if p.kind == "ffn":
        x, h = add_norm(p.norm, x, r, cfg.norm_eps)
        return x, apply_mlp(p.mlp, h, cfg.mlp_act)
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
    a, _ = attn_lib.apply_attention_prefill(p.attn, h, cfg, positions, entry, rope=rope,
                                            window=_window(cfg, p.kind),
                                            block_tables=block_tables)
    return _mlp_branch(p, cfg, x, h, a)


def _apply_block_decode(p: Block, cfg: ModelConfig, x: torch.Tensor,
                        r: Optional[torch.Tensor], positions: torch.Tensor, rope,
                        entry: Dict, block_tables: Optional[torch.Tensor],
                        update_mask: Optional[torch.Tensor]) -> Residual:
    if p.kind == "rglru":
        return _apply_rglru_block(p, cfg, x, r, entry, update_mask)
    if p.kind == "ffn":
        x, h = add_norm(p.norm, x, r, cfg.norm_eps)
        return x, apply_mlp(p.mlp, h, cfg.mlp_act)
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
    a, _ = attn_lib.apply_attention_decode(p.attn, h, cfg, positions, entry, rope=rope,
                                           window=_window(cfg, p.kind),
                                           block_tables=block_tables,
                                           update_mask=update_mask)
    return _mlp_branch(p, cfg, x, h, a)


class Model(nn.Module):
    """Parameters of a decoder, named like the reference's tree:
    ``embed.table``, ``lm_head.table`` (untied only), ``layers.<i>.<part>``
    for ``decoder`` layer i, ``final_norm.scale``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        device = resolve_device(device)
        dtype = _dtype(cfg.param_dtype)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg.vocab_size, cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, kind, dtype, device) for kind in cfg.blocks())
        self.final_norm = Norm(cfg.d_model, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _head(self) -> Embedding:
        return self.lm_head if hasattr(self, "lm_head") else self.embed

    def init_cache(self, batch: int, max_len: int, dtype=None, *,
                   layout: str = "contiguous", block_size: int = 16,
                   num_blocks: int = 0) -> Cache:
        """One cache entry per layer.  ``layout="paged"`` gives full-context
        attention layers a global block pool (``num_blocks`` x
        ``block_size``; 0: the worst case) that the caller addresses through
        block tables; sliding-window rings and recurrent states stay per
        row."""
        if layout not in ("contiguous", "paged"):
            raise ValueError(f"layout {layout!r} is not 'contiguous' or 'paged'")
        dtype = dtype or _dtype(self.cfg.dtype)
        return [cache_lib.init_block_cache(self.cfg, blk.kind, batch, max_len,
                                           dtype, self.device, layout=layout,
                                           block_size=block_size, num_blocks=num_blocks)
                for blk in self.layers]

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Process the prompt ``batch["tokens"]`` (B, S), fill ``cache`` in
        place; returns the last position's fp32 logits (B, vocab).
        Recurrent layers start from the state in ``cache`` (zeros in a fresh
        one).  A paged cache takes ``block_tables`` (B, blocks_per_slot)
        int32: the pool blocks each row's prompt fills."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(self.embed, tokens, cfg.emb_scale, cfg.d_model)
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S).contiguous()
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
        r = None
        for blk, entry in zip(self.layers, cache):
            x, r = _apply_block_seq(blk, cfg, x, r, positions, rope, entry, block_tables)
        _, h = add_norm(self.final_norm, x, r, cfg.norm_eps)
        logits = unembed(self._head(), h[:, -1:], cfg.logit_softcap)[:, 0]
        return logits, cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, position, cache: Cache,
                    block_tables: Optional[torch.Tensor] = None,
                    update_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step.  token (B, 1); position an int or (B,) tensor.
        ``block_tables`` (B, blocks_per_slot) int32 is required for a paged
        cache.  ``update_mask`` (B,) bool freezes the cache writes and
        recurrent states of masked-off rows.  Updates ``cache`` in place;
        returns fp32 logits (B, vocab).  Nothing here waits for the device,
        so a CUDA graph can capture the step."""
        cfg = self.cfg
        B = token.shape[0]
        positions = torch.as_tensor(position, dtype=torch.int32,
                                    device=token.device).expand(B).contiguous()
        x = embed_tokens(self.embed, token, cfg.emb_scale, cfg.d_model)
        rope = rope_tables(positions[:, None], cfg.resolved_head_dim, cfg.rope_theta)
        r = None
        for blk, entry in zip(self.layers, cache):
            x, r = _apply_block_decode(blk, cfg, x, r, positions, rope, entry, block_tables,
                                       update_mask)
        _, h = add_norm(self.final_norm, x, r, cfg.norm_eps)
        logits = unembed(self._head(), h, cfg.logit_softcap)[:, 0]
        return logits, cache


@torch.no_grad()
def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Model:
    """A model with weights drawn from ``generator`` (which must live on
    ``device``) at the reference initializer's scales: N(0,1)/sqrt(fan-in)
    for projections, 1/sqrt(Hq*hd) for wo, 1/sqrt(d_ff) for wd, N(0,1) for
    embeddings, zeros for norm scales and biases; the RG-LRU's ``lambda``
    is the reference's fixed formula."""
    model = Model(cfg, device=device)
    for module in model.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    return model
