"""The decoder, the counterpart of ``repro/models/model.py`` for the block
kinds ``attn``, ``local_attn`` (sliding window over a ring cache), ``ffn``,
``rglru`` (Griffin's recurrent block) and the xLSTM cells ``mlstm`` and
``slstm`` (a norm and the cell, no MLP).  In a MoE config the attention
blocks' MLP is the mixture of experts (``models/moe.py``; its blocked
dispatch under ``flags.use_moe_blocked()``); ``ffn`` and ``rglru`` blocks
keep the dense MLP, as in the reference.

An encoder-decoder config (``num_encoder_layers`` > 0) adds the encoder
stack (``Encoder``: unmasked attention blocks over frame embeddings, a
dense MLP of its own width, its own final norm), and each decoder
attention block a cross attention over the encoder's output after its
self-attention (``norm_c``, ``cross``).  A vision config
(``num_vision_tokens`` > 0) prepends the caller's patch embeddings to the
token embeddings; its text tokens then start at position
``num_vision_tokens``.

The reference stacks each repetition of ``cfg.block_pattern`` on a leading
axis and scans over it; here the layers are a plain ``nn.ModuleList`` run
in order (``bridge.params_from_jax`` unstacks the reference's groups).

Tensor parallelism: a model built with ``mesh=`` (a ``launch.mesh.TPMesh``
of more than one rank) is one rank's shard, Megatron-style, with the
reference's serving rules (``sharding/rules.py``): the q/k/v heads, the FFN
hidden, the experts (a MoE layer's E / tp experts and router columns, its
shared MLP's hidden), the RG-LRU and mLSTM widths, the sLSTM's FFN and the
vocabulary split over the ranks where tp divides them, whole on every rank
where it does not; norms and the sLSTM cell replicated, a vision prefix's
patch embeddings an input every rank is given.  Each module takes the
shard count and decides what it splits (``partial``: its output is a
partial sum).  A branch's partial outputs are reduced over the ranks
before they join the residual stream (a parallel block sums its two first
and reduces once, a MoE layer its routed and shared partials), each kept
in fp32 and the sum rounded once to the stream's dtype; a whole output is
added after the reduce, never summed over the ranks (``_reduce``).  The
embedding and the logits are vocabulary parallel (``layers.embed_tokens``,
``layers.unembed``), a MoE layer's router logits gathered whole
(``models/moe.py``), the recurrent cells' collectives in
``models/recurrent.py`` and the attention's in ``models/attention.py``.
The residual stream, the logits and so every sampled token are the same
on every rank.  ``sharding.partition.shard_model`` draws a shard's
weights; ``init_cache`` makes the rank's cache, each leaf laid out as the
reference's ``cache_shardings``.  An encoder-decoder model's encoder and
cross attention shard by the same rules (training only: no engine serves
one).  Under grad the collectives are ``sharding.collectives``'
differentiable ones.

A ``("data", "model")`` mesh adds FSDP over the data axis
(``sharding/fsdp.py``, set as ``Model.fsdp``): the model then stores each
parameter's data shard, and ``forward_train``, ``prefill`` and
``decode_step`` gather a module's parameters just before it runs (each
block, the encoder's blocks, the embedding, the head) and drop them
after; the backward reduce-scatters their gradients.  The caller gives
``prefill`` and ``decode_step`` the rank's rows of the batch and its
cache (``sharding.partition.rank_rows``, ``rank_cache``).  Without FSDP
each module runs as stored.

Under the serve rules (``sharding.rules.use_serve_rules``, the
reference's ``SERVE_RULES``) ``decode_step`` on such a rank is
weight-stationary: nothing is gathered per weight.  It gathers the
rank's rows of the token and positions over data once, so the batch is
whole on every rank, and runs every module on its stored 2-D shard with
the residual stream as the rank's slice of ``d`` (``layers.ServeLayout``,
the slices of the weights' ``embed`` dim): the embedding's table slice,
K1's split norms, products into a branch summed over the slices, the
attention over the rows whose cache the rank holds (its outputs gathered
over data), products out of a branch reduced over model once as above,
and the head's logits summed over the slices and gathered over model.
Every rank returns the whole batch's logits.  It runs the attention and
dense-MLP blocks (``rules.check_serve`` refuses the others by name).

Entry points:
  * ``init(cfg, generator, device)`` — a model with random weights at the
    reference initializer's scales.
  * ``Model.init_cache``  — one cache entry per layer.
  * ``Model.prefill``     — the prompt (with the batch's ``enc_embeds`` or
    ``vision_embeds``, as the config needs); fills the cache, returns the
    last position's logits.
  * ``Model.prefill_chunk`` — one chunk of a prompt against the cache
    (chunked prefill; ragged rows for the serving engine's unified step;
    the speculative verify window, with every column's logits).
  * ``Model.decode_step`` — one token against the cache (the TPOT step).
  * ``Model.forward_train`` — teacher-forced fp32 logits of a whole
    sequence with no cache (every family: the patches before the tokens,
    the encoder and cross attention, the recurrent cells from a fresh
    state), differentiable (K1, K2 and K5 through their
    ``autograd.Function``s), optionally rematerialised per group.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, ContextManager, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import cache as cache_lib
from repro_torch.models import flags
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Embedding, Norm, ServeLayout, add_norm, embed_tokens, rope_tables, unembed,
)
from repro_torch.models.mlp import MLP, apply_mlp
from repro_torch.sharding import collectives
from repro_torch.sharding import rules as rules_lib

SUPPORTED_BLOCKS = ("attn", "local_attn", "ffn", "rglru", "mlstm", "slstm")
ATTN_BLOCKS = ("attn", "local_attn")
XLSTM_BLOCKS = ("mlstm", "slstm")

Cache = List[Dict[str, torch.Tensor]]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Block(nn.Module):
    """One layer of ``cfg``, each module of it one of ``shards`` ranks'
    shard (whole where tp does not divide what it would split)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device, shards: int = 1):
        super().__init__()
        if kind not in SUPPORTED_BLOCKS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"(the port runs {SUPPORTED_BLOCKS})")
        self.kind = kind
        self.shards = shards
        self.tp = None  # the mesh of a tensor-parallel shard (set by Model)
        d = cfg.d_model
        if kind in ATTN_BLOCKS:
            self.norm1 = Norm(d, dtype, device)
            self.attn = attn_lib.Attention(cfg, dtype, device, shards=shards)
            if not cfg.parallel_block:  # one shared pre-norm (Cohere/GPT-J style)
                self.norm2 = Norm(d, dtype, device)
        elif kind == "rglru":
            self.norm1 = Norm(d, dtype, device)
            self.rec = rec_lib.RGLRU(cfg, dtype, device, shards)
            self.norm2 = Norm(d, dtype, device)
        else:
            self.norm = Norm(d, dtype, device)
        if kind in XLSTM_BLOCKS:  # no MLP: the cell holds the block's projections
            cell = rec_lib.MLSTM if kind == "mlstm" else rec_lib.SLSTM
            self.cell = cell(cfg, dtype, device, shards)
        elif kind in ATTN_BLOCKS and cfg.is_moe:
            self.mlp = moe_lib.MoE(cfg, dtype, device, shards)
        else:
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp_gated, dtype, device, shards)
        if cfg.is_encdec and kind in ATTN_BLOCKS:  # a decoder block of an enc-dec model
            self.norm_c = Norm(d, dtype, device)
            self.cross = attn_lib.Attention(cfg, dtype, device, cross=True, shards=shards)


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: attention blocks with a dense MLP of
    the encoder's own width, as the reference's ``_enc_cfg``."""
    return cfg.replace(block_pattern=("attn",), num_layers=cfg.num_encoder_layers,
                       d_ff=cfg.encoder_d_ff or cfg.d_ff, num_experts=0,
                       num_experts_per_tok=0, num_encoder_layers=0)


class Encoder(nn.Module):
    """The encoder of an encoder-decoder model: ``layers`` of attention
    blocks and a ``final_norm`` of its own, over ``_enc_cfg``; each layer
    one of ``shards`` ranks' shard."""

    def __init__(self, cfg: ModelConfig, dtype, device, shards: int = 1):
        super().__init__()
        self.cfg = _enc_cfg(cfg)
        self.layers = nn.ModuleList(Block(self.cfg, "attn", dtype, device, shards)
                                    for _ in range(self.cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, dtype, device)


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
# A cross-attention block folds its self-attention output into ``norm_c``
# the same way.
Residual = Tuple[torch.Tensor, Optional[torch.Tensor]]
# An encoder-decoder model's encoder output and its frame indices, (B, T, d)
# and (B, T) int32, for the decoder blocks' cross attention
Memory = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _apply_rglru_block(p: Block, cfg: ModelConfig, x: torch.Tensor,
                       r: Optional[torch.Tensor], entry: Dict,
                       update_mask: Optional[torch.Tensor] = None) -> Residual:
    """norm1 -> RG-LRU from the entry's state -> residual -> norm2 -> MLP.
    The scan starts from the state in ``entry`` (its initial values in a
    fresh cache)."""
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
    y, state = rec_lib.apply_rglru_seq(p.rec, h, cfg, entry)
    _write_state(entry, state, update_mask)
    x, h = add_norm(p.norm2, x, _reduce(p, x, (y, p.rec.partial)), cfg.norm_eps)
    return x, _reduce(p, x, (apply_mlp(p.mlp, h, cfg.mlp_act), p.mlp.partial))


def _apply_xlstm_block(p: Block, cfg: ModelConfig, x: torch.Tensor,
                       r: Optional[torch.Tensor], entry: Dict,
                       valid: Optional[torch.Tensor] = None,
                       update_mask: Optional[torch.Tensor] = None,
                       step: bool = False) -> Residual:
    """norm -> the mLSTM or sLSTM cell from the entry's state, its output
    left pending.  A sequence or chunk (``valid``: identity steps at pad
    columns, so its state is written unmasked) or, with ``step``, one
    decode step (rows off in ``update_mask`` keep their state)."""
    x, h = add_norm(p.norm, x, r, cfg.norm_eps)
    if step:
        fn = rec_lib.apply_mlstm_step if p.kind == "mlstm" else rec_lib.apply_slstm_step
        y, state = fn(p.cell, h, cfg, entry)
    else:
        fn = rec_lib.apply_mlstm_seq if p.kind == "mlstm" else rec_lib.apply_slstm_seq
        y, state = fn(p.cell, h, cfg, entry, valid)
    _write_state(entry, state, update_mask)
    return x, _reduce(p, x, (y, p.cell.partial))


def _cross(p: Block, cfg: ModelConfig, x: torch.Tensor, a: torch.Tensor,
           attend: Callable[[torch.Tensor], torch.Tensor],
           serve: Optional[ServeLayout] = None) -> Residual:
    """A decoder block's cross attention after its self-attention output
    ``a``: ``a`` (reduced over a shard's ranks) added in ``norm_c`` (K1's
    fused mode), ``attend`` on the norm, its output left pending, as the
    reference's ``x = x + a; x = x + cross(norm_c(x))``.  The cross
    attention splits its heads as the self-attention does, so the pending
    output is reduced as the self-attention's would be."""
    x, hc = add_norm(p.norm_c, x, _reduce(p, x, (a, p.attn.partial)), cfg.norm_eps, serve)
    return x, attend(hc)


def _reduce(p: Block, x: torch.Tensor, *parts: Tuple[torch.Tensor, bool]) -> torch.Tensor:
    """The sum of a block's branch outputs ``parts``, each (output, whether
    it is a partial sum): the partial ones, row-parallel products' fp32
    partials, summed, reduced over the tensor-parallel shard's ranks once
    and rounded to the residual stream's dtype (the reference's constraint
    back to a replicated residual); a whole one, which every rank computed
    alike, added after, never summed over the ranks.  Without tensor
    parallelism no output is partial."""
    partial = [t for t, is_partial in parts if is_partial]
    out = None
    if partial:
        out = collectives.reduce(functools.reduce(torch.add, partial), p.tp).to(x.dtype)
    for t, is_partial in parts:
        if not is_partial:
            out = t if out is None else out + t
    return out


def _ffn_block(p: Block, cfg: ModelConfig, x: torch.Tensor,
               r: Optional[torch.Tensor], serve: Optional[ServeLayout] = None) -> Residual:
    x, h = add_norm(p.norm, x, r, cfg.norm_eps, serve)
    return x, _reduce(p, x, (apply_mlp(p.mlp, h, cfg.mlp_act, serve), p.mlp.partial))


def _mlp_branch(p: Block, cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor,
                a: torch.Tensor, serve: Optional[ServeLayout] = None) -> Residual:
    """An attention block after its attention output ``a``: the MLP branch
    (the mixture of experts in a MoE config), left pending.  A parallel
    block's MLP reads the shared pre-norm ``h`` and adds ``a`` first, as
    the reference adds ``(x + a) + m``; on a tensor-parallel shard its two
    partial outputs are summed and reduced once, ``x + (a + m)``.  A MoE
    shard's routed and shared partials are summed in the layer and reduced
    once.  Under the serve rules (``serve``) each branch is the rank's
    slice of ``d``."""
    if cfg.parallel_block:
        if p.tp is not None:
            return x, _reduce(p, x, (a, p.attn.partial),
                              (apply_mlp(p.mlp, h, cfg.mlp_act, serve), p.mlp.partial))
        x = x + a
    else:
        x, h = add_norm(p.norm2, x, _reduce(p, x, (a, p.attn.partial)), cfg.norm_eps, serve)
    if cfg.is_moe:
        moe_fn = moe_lib.apply_moe_blocked if flags.moe_blocked() else moe_lib.apply_moe
        return x, _reduce(p, x, *moe_fn(p.mlp, h, cfg, parts=True))
    return x, _reduce(p, x, (apply_mlp(p.mlp, h, cfg.mlp_act, serve), p.mlp.partial))


def _apply_block_seq(p: Block, cfg: ModelConfig, x: torch.Tensor,
                     r: Optional[torch.Tensor], positions: torch.Tensor, rope, entry: Dict,
                     block_tables: Optional[torch.Tensor], memory: Memory = None) -> Residual:
    if p.kind == "rglru":
        return _apply_rglru_block(p, cfg, x, r, entry)
    if p.kind in XLSTM_BLOCKS:
        return _apply_xlstm_block(p, cfg, x, r, entry)
    if p.kind == "ffn":
        return _ffn_block(p, cfg, x, r)
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
    a, _ = attn_lib.apply_attention_prefill(p.attn, h, cfg, positions, entry, rope=rope,
                                            window=_window(cfg, p.kind),
                                            block_tables=block_tables)
    if hasattr(p, "cross"):
        x, a = _cross(p, cfg, x, a, lambda hc: attn_lib.apply_cross_attention_seq(
            p.cross, hc, positions, *memory, entry))
    return _mlp_branch(p, cfg, x, h, a)


def _apply_block_chunk(p: Block, cfg: ModelConfig, x: torch.Tensor,
                       r: Optional[torch.Tensor], positions: torch.Tensor, rope, entry: Dict,
                       block_tables: Optional[torch.Tensor],
                       valid: Optional[torch.Tensor],
                       overwrite_from: Optional[torch.Tensor] = None,
                       memory: Memory = None) -> Residual:
    """A prompt chunk against the cache: attention over the earlier
    chunks plus this one, a recurrent cell resumed from the carried state
    with identity steps at pad columns (so its state is written unmasked:
    a row with no valid column keeps it)."""
    if p.kind == "rglru":
        x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
        y, state = rec_lib.apply_rglru_seq(p.rec, h, cfg, entry, valid)
        _write_state(entry, state)
        x, h = add_norm(p.norm2, x, _reduce(p, x, (y, p.rec.partial)), cfg.norm_eps)
        return x, _reduce(p, x, (apply_mlp(p.mlp, h, cfg.mlp_act), p.mlp.partial))
    if p.kind in XLSTM_BLOCKS:
        return _apply_xlstm_block(p, cfg, x, r, entry, valid)
    if p.kind == "ffn":
        return _ffn_block(p, cfg, x, r)
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
    a, _ = attn_lib.apply_attention_prefill_chunk(p.attn, h, cfg, positions, entry,
                                                  rope=rope, window=_window(cfg, p.kind),
                                                  block_tables=block_tables, valid=valid,
                                                  overwrite_from=overwrite_from)
    if hasattr(p, "cross"):
        x, a = _cross(p, cfg, x, a, lambda hc: attn_lib.apply_cross_attention_seq(
            p.cross, hc, positions, *memory, entry))
    return _mlp_branch(p, cfg, x, h, a)


def _apply_block_decode(p: Block, cfg: ModelConfig, x: torch.Tensor,
                        r: Optional[torch.Tensor], positions: torch.Tensor, rope,
                        entry: Dict, block_tables: Optional[torch.Tensor],
                        update_mask: Optional[torch.Tensor],
                        serve: Optional[ServeLayout] = None) -> Residual:
    """One block of a decode step; under the serve rules (``serve``: an
    attention or FFN block, ``rules.check_serve``) on the rank's slice of
    the residual stream."""
    if p.kind == "rglru":
        return _apply_rglru_block(p, cfg, x, r, entry, update_mask)
    if p.kind in XLSTM_BLOCKS:
        return _apply_xlstm_block(p, cfg, x, r, entry, update_mask=update_mask, step=True)
    if p.kind == "ffn":
        return _ffn_block(p, cfg, x, r, serve)
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps, serve)
    a, _ = attn_lib.apply_attention_decode(p.attn, h, cfg, positions, entry, rope=rope,
                                           window=_window(cfg, p.kind),
                                           block_tables=block_tables,
                                           update_mask=update_mask, serve=serve)
    if hasattr(p, "cross"):
        x, a = _cross(p, cfg, x, a, lambda hc: attn_lib.apply_cross_attention_decode(
            p.cross, hc, positions, entry, serve), serve)
    return _mlp_branch(p, cfg, x, h, a, serve)


def _apply_block_train(p: Block, cfg: ModelConfig, x: torch.Tensor,
                       r: Optional[torch.Tensor], positions: torch.Tensor, rope,
                       memory: Memory = None) -> Residual:
    """A block of the training forward: the prefill's arithmetic with no
    cache, a recurrent cell from a fresh state (its initial values; the
    reference passes ``cache=None``), cross attention over ``memory``
    with its K/V projected and attended, never stored, and nothing
    written in place."""
    if p.kind == "ffn":
        return _ffn_block(p, cfg, x, r)
    if p.kind not in ATTN_BLOCKS:
        norm = p.norm if p.kind in XLSTM_BLOCKS else p.norm1
        x, h = add_norm(norm, x, r, cfg.norm_eps)
        state = cache_lib.init_block_cache(cfg, p.kind, x.shape[0], 0, x.dtype, x.device,
                                           shards=p.shards)
        if p.kind == "rglru":
            y, _ = rec_lib.apply_rglru_seq(p.rec, h, cfg, state)
            x, h = add_norm(p.norm2, x, _reduce(p, x, (y, p.rec.partial)), cfg.norm_eps)
            return x, _reduce(p, x, (apply_mlp(p.mlp, h, cfg.mlp_act), p.mlp.partial))
        fn = rec_lib.apply_mlstm_seq if p.kind == "mlstm" else rec_lib.apply_slstm_seq
        return x, _reduce(p, x, (fn(p.cell, h, cfg, state)[0], p.cell.partial))
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
    a = attn_lib.apply_attention_train(p.attn, h, cfg, positions, rope=rope,
                                       window=_window(cfg, p.kind))
    if hasattr(p, "cross"):
        x, a = _cross(p, cfg, x, a, lambda hc: attn_lib.apply_cross_attention_seq(
            p.cross, hc, positions, *memory))
    return _mlp_branch(p, cfg, x, h, a)


def _encoder_block(p: Block, cfg: ModelConfig, x: torch.Tensor, r: Optional[torch.Tensor],
                   positions: torch.Tensor, rope) -> Residual:
    """An encoder block: unmasked self-attention over the frames, then its
    dense MLP."""
    x, h = add_norm(p.norm1, x, r, cfg.norm_eps)
    a = attn_lib.apply_attention_train(p.attn, h, cfg, positions, rope=rope, causal=False)
    return _mlp_branch(p, cfg, x, h, a)


Unit = Callable[[nn.Module], ContextManager]


def _whole(module: nn.Module) -> ContextManager:
    """A module's parameters as they are stored (no FSDP)."""
    return contextlib.nullcontext()


def _run_stack(layers, cfg: ModelConfig, x: torch.Tensor, remat: bool,
               apply: Callable[[Block, torch.Tensor, Optional[torch.Tensor]], Residual],
               unit: Unit = _whole) -> Residual:
    """``apply`` over ``layers`` in order from the residual pair (x, None),
    each block inside ``unit(block)`` (FSDP's gather of its parameters).
    With ``remat`` each group (one repetition of ``cfg.block_pattern``)
    runs under ``checkpoint``, so the backward recomputes it instead of
    keeping its activations, as the reference's
    ``jax.checkpoint(nothing_saveable)`` over its scanned groups, and
    gathers its parameters again; the remainder layers are not wrapped."""
    def run(x, r, blocks):
        for blk in blocks:
            with unit(blk):
                x, r = apply(blk, x, r)
        return x, r

    plen, (n_groups, _) = len(cfg.block_pattern), cfg.layer_groups()
    layers = list(layers)
    r = None
    for g in range(n_groups):
        group = layers[g * plen:(g + 1) * plen]
        if remat:
            x, r = checkpoint(run, x, r, group, use_reentrant=False)
        else:
            x, r = run(x, r, group)
    return run(x, r, layers[n_groups * plen:])


class Model(nn.Module):
    """Parameters of a decoder, named like the reference's tree:
    ``embed.table``, ``lm_head.table`` (untied only), ``layers.<i>.<part>``
    for ``decoder`` layer i, ``final_norm.scale``; an encoder-decoder
    model's encoder under ``encoder.layers.<i>.<part>`` and
    ``encoder.final_norm.scale``."""

    def __init__(self, cfg: ModelConfig, device="cuda", mesh=None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        # a tensor-parallel shard: its modules at the shard's shapes, its
        # collectives on ``mesh``
        self.mesh = mesh
        self.fsdp = None  # a data-sharded training model's FSDP (``sharding.fsdp``)
        self.placement = None  # a training mesh rank's ``sharding.partition.Placement``
        tp, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
        rules_lib.check_train_tp(cfg, tp)
        self.shards = tp
        device = resolve_device(device)
        if mesh is not None and device != mesh.device and device.type != "meta":
            raise ValueError(f"a shard of the mesh on {mesh.device} cannot be built on {device}")
        shard = mesh if tp > 1 else None
        dtype = _dtype(cfg.param_dtype)
        v = rules_lib.local_size(cfg.vocab_size, tp)
        # a vocabulary tp does not divide is whole: no gather of the logits
        vocab_tp = shard if v < cfg.vocab_size else None
        self.embed = Embedding(v, cfg.d_model, dtype, device, vocab_tp, rank * v if vocab_tp else 0)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(v, cfg.d_model, dtype, device, vocab_tp,
                                     rank * v if vocab_tp else 0)
        self.layers = nn.ModuleList(Block(cfg, kind, dtype, device, tp)
                                    for kind in cfg.blocks())
        self.final_norm = Norm(cfg.d_model, dtype, device)
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, dtype, device, tp)
        for module in self.modules():  # the blocks and the modules whose collectives need it
            if hasattr(module, "tp") and not isinstance(module, Embedding):
                module.tp = shard

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _head(self) -> Embedding:
        return self.lm_head if hasattr(self, "lm_head") else self.embed

    def _unit(self) -> Unit:
        """How a forward holds a module's parameters while it runs:
        gathered over the data axis under FSDP, else as stored."""
        return self.fsdp.gathered if self.fsdp is not None else _whole

    def _embed_inputs(self, tokens: torch.Tensor,
                      vision_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """The token embeddings, after the patch embeddings (B, nv, d) of a
        vision config where the caller passes them."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, cfg.emb_scale, cfg.d_model)
        if cfg.num_vision_tokens > 0 and vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
        return x

    def _encode(self, enc_embeds: Optional[torch.Tensor], remat: bool = False,
                unit: Unit = _whole) -> Memory:
        """The encoder over the frame embeddings (B, T, d), none without an
        encoder: its output and the frames' indices, which its attention
        rotates by and the decoder's cross attention takes as key
        positions.  ``remat`` recomputes each encoder layer in the
        backward (``_run_stack``)."""
        if not self.cfg.is_encdec:
            return None
        if enc_embeds is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder model needs enc_embeds")
        enc, cfg = self.encoder, self.encoder.cfg
        x = enc_embeds.to(self.embed.table.dtype)
        B, T = x.shape[:2]
        positions = torch.arange(T, dtype=torch.int32, device=x.device).expand(B, T).contiguous()
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
        x, r = _run_stack(enc.layers, cfg, x, remat,
                          lambda blk, x, r: _encoder_block(blk, cfg, x, r, positions, rope), unit)
        _, memory = add_norm(enc.final_norm, x, r, cfg.norm_eps)
        return memory, positions

    def forward_train(self, batch: Dict[str, torch.Tensor], remat: bool = True) -> torch.Tensor:
        """Teacher-forced fp32 logits (B, nv + S, vocab) of
        ``batch["tokens"]`` (B, S), after a vision config's
        ``batch["vision_embeds"]`` (nv of them) and over an encoder-decoder
        config's encoder output of ``batch["enc_embeds"]``, the
        reference's ``forward_train``: no cache and no ``no_grad``, the
        prefill's fused residual pattern.  ``remat`` recomputes each group
        of the decoder and of the encoder in the backward
        (``_run_stack``); the kernels' forwards launch again in a
        recompute.  Under FSDP each module's parameters are gathered just
        before it runs (``_unit``)."""
        cfg = self.cfg
        unit = self._unit()
        with unit(self.embed):
            x = self._embed_inputs(batch["tokens"], batch.get("vision_embeds"))
        memory = self._encode(batch.get("enc_embeds"), remat=remat, unit=unit)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S).contiguous()
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
        x, r = _run_stack(self.layers, cfg, x, remat, lambda blk, x, r: _apply_block_train(
            blk, cfg, x, r, positions, rope, memory), unit)
        _, h = add_norm(self.final_norm, x, r, cfg.norm_eps)
        with unit(self._head()):
            return unembed(self._head(), h, cfg.logit_softcap)

    def init_cache(self, batch: int, max_len: int, dtype=None, *,
                   layout: str = "contiguous", block_size: int = 16,
                   num_blocks: int = 0) -> Cache:
        """One cache entry per layer.  ``layout="paged"`` gives full-context
        attention layers a global block pool (``num_blocks`` x
        ``block_size``; 0: the worst case) that the caller addresses through
        block tables; sliding-window rings and recurrent states stay per
        row.  A tensor-parallel shard's entries hold its shard of each leaf
        (``sharding.rules.cache_dim``)."""
        return cache_lib.init_cache(self.cfg, batch, max_len,
                                    dtype or _dtype(self.cfg.dtype), self.device,
                                    layout=layout, block_size=block_size,
                                    num_blocks=num_blocks, shards=self.shards)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Process the prompt ``batch["tokens"]`` (B, S), fill ``cache`` in
        place; returns the last position's fp32 logits (B, vocab).
        Recurrent layers start from the state in ``cache`` (its initial
        values in a fresh one).  A paged cache takes ``block_tables`` (B,
        blocks_per_slot) int32: the pool blocks each row's prompt fills.
        An encoder-decoder model takes ``batch["enc_embeds"]`` (B, T, d),
        T at most the cache's ``max_len // 2``; a vision model
        ``batch["vision_embeds"]`` (B, nv, d) at positions 0..nv-1, the
        tokens after them (the first decode position is then nv + S)."""
        cfg = self.cfg
        unit = self._unit()
        with unit(self.embed):
            x = self._embed_inputs(batch["tokens"], batch.get("vision_embeds"))
        memory = self._encode(batch.get("enc_embeds"), unit=unit)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S).contiguous()
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
        r = None
        for blk, entry in zip(self.layers, cache):
            with unit(blk):
                x, r = _apply_block_seq(blk, cfg, x, r, positions, rope, entry, block_tables,
                                        memory)
        _, h = add_norm(self.final_norm, x, r, cfg.norm_eps)
        with unit(self._head()):
            logits = unembed(self._head(), h[:, -1:], cfg.logit_softcap)[:, 0]
        return logits, cache

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, cache: Cache, start,
                      block_tables: Optional[torch.Tensor] = None,
                      lengths: Optional[torch.Tensor] = None,
                      overwrite_from: Optional[torch.Tensor] = None,
                      all_logits: bool = False,
                      vision_embeds: Optional[torch.Tensor] = None,
                      enc_embeds: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
        """One prompt chunk ``tokens`` (B, C) at positions ``start ..
        start + C - 1`` against a cache that holds positions ``0 ..
        start - 1``; updates ``cache`` in place.  ``start`` is an int or a
        (B,) int32 tensor (one start per row, the unified step).
        ``lengths`` (B,) int32 marks how many of each row's C columns are
        tokens: pad columns write nothing, recurrent states take identity
        steps there, and a row of length 0 leaves its cache rows as they
        were.  Returns the fp32 logits (B, vocab) of each row's last valid
        position (of the last column without ``lengths``; garbage for a
        row of length 0).  Nothing here waits for the device, so a CUDA
        graph can capture it.

        The speculative verify step scores a draft window through this
        path: ``overwrite_from`` (B,) int32 hides stale contiguous cache
        entries at positions >= the row's value
        (``attention.apply_attention_prefill_chunk``), and ``all_logits``
        returns the fp32 logits of every column, (B, C, vocab).

        An encoder-decoder model takes ``enc_embeds`` with every chunk and
        runs its encoder again, as the reference does.  A vision model
        takes ``vision_embeds`` with the chunk at ``start`` 0 only (its
        columns then come first); a later chunk's ``start`` counts them.
        ``lengths`` does not go with ``vision_embeds``."""
        cfg = self.cfg
        if lengths is not None and vision_embeds is not None:
            raise ValueError("lengths does not go with vision_embeds")
        x = self._embed_inputs(tokens, vision_embeds)
        memory = self._encode(enc_embeds)
        B, C = x.shape[:2]
        cols = torch.arange(C, dtype=torch.int32, device=tokens.device)
        start = torch.as_tensor(start, dtype=torch.int32, device=tokens.device)
        positions = (start.reshape(-1, 1) + cols[None]).expand(B, C).contiguous()
        valid = None if lengths is None else cols[None] < lengths[:, None]
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
        r = None
        for blk, entry in zip(self.layers, cache):
            x, r = _apply_block_chunk(blk, cfg, x, r, positions, rope, entry, block_tables,
                                      valid, overwrite_from, memory)
        if all_logits:
            _, h = add_norm(self.final_norm, x, r, cfg.norm_eps)
            return unembed(self._head(), h, cfg.logit_softcap), cache
        if lengths is None:  # the last column, contiguous for K1 at any batch
            x, r = x[:, -1:].contiguous(), r[:, -1:].contiguous()
        else:  # each row's last valid column, before the final norm (rowwise)
            idx = (lengths.long() - 1).clamp(0, C - 1)[:, None, None].expand(-1, 1, x.shape[2])
            x, r = torch.gather(x, 1, idx), torch.gather(r, 1, idx)
        _, h = add_norm(self.final_norm, x, r, cfg.norm_eps)
        return unembed(self._head(), h, cfg.logit_softcap)[:, 0], cache

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
        so a CUDA graph can capture the step.

        Under FSDP each module's parameters are gathered as it runs; under
        the serve rules too (``rules.use_serve_rules``) the step is
        weight-stationary instead (the module docstring): it takes the
        rank's rows of ``token``, ``position`` and ``update_mask`` (as
        ``sharding.partition.rank_rows`` gives them) and returns the whole
        batch's logits."""
        cfg = self.cfg
        B = token.shape[0]
        positions = torch.as_tensor(position, dtype=torch.int32,
                                    device=token.device).expand(B).contiguous()
        unit, serve = self._unit(), None
        if self.fsdp is not None and rules_lib.serve_rules():
            serve, token, positions, update_mask = self._serve_inputs(
                token, positions, update_mask, block_tables)
            unit = _whole
        with unit(self.embed):
            x = embed_tokens(self.embed, token, cfg.emb_scale, cfg.d_model)
        rope = rope_tables(positions[:, None], cfg.resolved_head_dim, cfg.rope_theta)
        r = None
        for blk, entry in zip(self.layers, cache):
            with unit(blk):
                x, r = _apply_block_decode(blk, cfg, x, r, positions, rope, entry,
                                           block_tables, update_mask, serve)
        _, h = add_norm(self.final_norm, x, r, cfg.norm_eps, serve)
        with unit(self._head()):
            logits = unembed(self._head(), h, cfg.logit_softcap, serve)[:, 0]
        return logits, cache

    def _serve_inputs(self, token: torch.Tensor, positions: torch.Tensor,
                      update_mask: Optional[torch.Tensor],
                      block_tables: Optional[torch.Tensor]):
        """A weight-stationary decode step's layout and its whole batch:
        the rank's rows of the token, positions (and update mask) gathered
        over data in one int32 all-gather where the rows split the batch
        (``FSDP.summed``, set by ``rank_rows``).  Returns (the
        ``ServeLayout``, token (B, 1), positions (B,), the mask)."""
        rules_lib.check_serve(self.cfg)
        if block_tables is not None:
            raise ValueError("a decode step under the serve rules runs a contiguous cache, "
                             "not block tables")
        placement, data = self.placement, self.fsdp.data
        rows = None
        if self.fsdp.summed:
            n = token.shape[0]
            cols = [token.reshape(n).to(torch.int32), positions]
            if update_mask is not None:
                cols.append(update_mask.to(torch.int32))
            whole = collectives.gather(torch.stack(cols, dim=-1), 0, data)
            token, positions = whole[:, :1].contiguous(), whole[:, 1].contiguous()
            if update_mask is not None:
                update_mask = whole[:, 2] != 0
            rows = slice(data.rank * n, (data.rank + 1) * n)
        axis, parts = placement.residual_split()
        serve = ServeLayout(axis=axis, index=axis.rank if axis is not None else 0, parts=parts,
                            width=self.cfg.d_model, data=data, rows=rows)
        return serve, token, positions, update_mask


@torch.no_grad()
def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Model:
    """A model with weights drawn from ``generator`` (which must live on
    ``device``) at the reference initializer's scales: N(0,1)/sqrt(fan-in)
    for projections (the experts' wg and wu on their first dimension, E),
    1/sqrt(Hq*hd) for wo, 1/sqrt(d_ff) for wd, N(0,1) for embeddings, zeros
    for norm scales and biases; the RG-LRU's ``lambda``
    is the reference's fixed formula, the xLSTM forget biases its
    ``linspace(3, 6)``."""
    model = Model(cfg, device=device)
    for module in model.modules():
        if hasattr(module, "init_"):
            module.init_(generator)
    return model
