"""Mixture-of-experts FFN, the counterpart of ``repro/models/moe.py``:
tokens choose their top-k experts, and a stable sort by expert gives each
(token, expert) pair its position in that expert's buffer of ``capacity``
rows; pairs past it are dropped.  The expert products run over every expert
(``torch.bmm`` over the (E, C, d) buffer), as the reference's einsums do.

Supports Moonlight-style shared experts (an always-on dense branch) and
Qwen3-MoE-style normalized top-k gates.

Nothing here waits for the device (no ``nonzero``, ``bincount``, boolean
indexing or ``.item()``; the capacity is a Python int from shapes), so the
serving engine's decode and unified steps stay capturable in CUDA graphs.
The capacity counts every row of a call, pad columns and idle slots
included, so whether a token is dropped depends on the rows beside it.

Tensor parallelism (the reference's ``experts`` rule): a rank of ``tp``
holds E / tp experts, rank r the experts r·E/tp .. (r+1)·E/tp - 1 and the
router's matching columns, and half, a quarter, ... of the shared MLP's
hidden.  Every rank computes its fp32 router logits (T, E/tp) and gathers
them into the whole (T, E) row (``TPMesh.gather_last``: the same bytes on
every rank), so every rank routes alike, over all E experts with the
capacity of tp = 1; the dispatch is tp = 1's.  A rank then runs the
products of its own experts only and gathers back the pairs they hold;
a pair whose expert is another rank's, or dropped, adds 0.  Its output is
a partial sum in fp32, which the model reduces over the ranks once,
beside the shared MLP's partial (``models/model.py``).  Where tp does not
divide E, every rank holds every expert and the whole router, and the
routed output is whole; a shared MLP whose width tp does not divide is
whole too.  ``moe_parts`` gives the two outputs with their kind, and the
model adds a whole one after the reduce of the partial ones.

Under grad a split layer's input and its gates (rank-local uses of
replicated tensors) are ``collectives.copy``'d and its router logits
gathered by ``collectives.gather``.

Data parallelism (training, ``p.dp``: the data axis, set by
``sharding.fsdp`` while a batch's rows are split over it): the reference
routes the global batch, so a data rank all-gathers its per-expert pair
counts, offsets its pairs' positions by the counts of the data ranks
before it, and takes the capacity from the global token count: it keeps
and drops exactly the pairs the reference does.  Its buffer still holds
C rows per expert, of which its own pairs fill some.  Under
``apply_moe_blocked`` a data rank is one block, with its own capacity, as
the reference's blocks are its data shards.

``routing(log, forced)`` records each call's routing or imposes one, to
hold two runs to the same routes in checks (bf16 flips top-k sets).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterable, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn, init_normal_, new_param
from repro_torch.models.mlp import MLP, apply_mlp
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import divides, local_size


def capacity(num_tokens: int, num_experts: int, k: int, factor: float) -> int:
    cap = int(math.ceil(num_tokens * k * factor / num_experts))
    # rounded up to a multiple of 8; at least k so that tiny inputs route
    return max(k, ((cap + 7) // 8) * 8)


class MoE(nn.Module):
    """``router`` (d, E), ``wg``/``wu`` (E, d, ff), ``wd`` (E, ff, d) and,
    with ``num_shared_experts``, a gated ``shared`` MLP of width
    ff * num_shared_experts: the reference's leaf names.  A shard of
    ``shards`` ranks holds E / shards experts and their router columns
    where that divides E (else all of them), and 1 / shards of the shared
    MLP's hidden where that divides it."""

    def __init__(self, cfg: ModelConfig, dtype, device, shards: int = 1):
        super().__init__()
        # a shard's routed output is one rank's partial sum, kept in fp32
        # for the sum over the ranks, where the experts are split
        self.partial = divides(shards, cfg.num_experts)
        d, e, ff = cfg.d_model, local_size(cfg.num_experts, shards), cfg.d_ff
        self.router = new_param((d, e), dtype, device)
        self.wg = new_param((e, d, ff), dtype, device)
        self.wu = new_param((e, d, ff), dtype, device)
        self.wd = new_param((e, ff, d), dtype, device)
        if cfg.num_shared_experts > 0:
            self.shared = MLP(d, ff * cfg.num_shared_experts, True, dtype, device, shards)
        # a tensor-parallel shard's mesh, for the router's gather (set by
        # ``Model``), and the data axis whose ranks split the batch's rows
        # (set by ``sharding.fsdp`` per batch)
        self.tp = None
        self.dp = None

    def init_(self, gen: torch.Generator) -> None:
        # the reference's scales: wg and wu take Maker.normal's default,
        # fan-in on the first dimension, which is E for these leaves
        init_normal_(self.router, gen, scale=1.0 / math.sqrt(self.router.shape[0]))
        init_normal_(self.wg, gen)
        init_normal_(self.wu, gen)
        init_normal_(self.wd, gen, scale=1.0 / math.sqrt(self.wd.shape[1]))


class _Routing:
    """The routing hook of ``routing``: a log of each call's (expert ids,
    kept) and an iterator of ids to impose, or None for either."""
    log: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
    forced: Optional[Iterable[torch.Tensor]] = None


@contextlib.contextmanager
def routing(log: Optional[list] = None, forced: Optional[Iterable[torch.Tensor]] = None):
    """Inside the block each MoE call appends (its (T, k) expert ids, its
    (T, k) bool mask of the pairs kept under the capacity) to ``log``;
    with ``forced`` (an iterable of (T, k) int64 ids, one per call, in
    call order) each call takes the next ids in place of its own top-k,
    its gates recomputed from its own probabilities at them.  For checks
    that hold two runs to the same routes; a forced call reads the host's
    list, so a CUDA graph must not capture it.  Raises if forced ids are
    left over."""
    prev = (_Routing.log, _Routing.forced)
    _Routing.log = log
    _Routing.forced = None if forced is None else iter(forced)
    try:
        yield
        if _Routing.forced is not None and next(_Routing.forced, None) is not None:
            raise ValueError("forced MoE routes were left over: the run made fewer MoE calls")
    finally:
        _Routing.log, _Routing.forced = prev


def route(logits: torch.Tensor, k: int, normalize: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the fp32 softmax probabilities.  logits (T, E) -> weights
    (T, k) fp32, expert ids (T, k) int64 (the next forced ids inside
    ``routing(forced=)``)."""
    probs = torch.softmax(logits.float(), dim=-1)
    if _Routing.forced is None:
        weights, idx = torch.topk(probs, k, dim=-1)
    else:
        idx = next(_Routing.forced, None)
        if idx is None:
            raise ValueError("ran out of forced MoE routes: the run made more MoE calls")
        idx = idx.to(device=probs.device, dtype=torch.int64)
        if idx.shape != (probs.shape[0], k):
            raise ValueError(f"forced MoE routes of shape {tuple(idx.shape)} for a call of "
                             f"{probs.shape[0]} rows, top-{k}")
        weights = probs.gather(-1, idx)
    if normalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx


def router_logits(p: MoE, xf: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, E) fp32: the router product in fp32, as the
    reference's ``preferred_element_type=float32``.  A shard of split
    experts computes its own experts' columns (T, E/tp) and gathers every
    rank's, in rank order: the whole row, the same bytes on every rank."""
    logits = torch.matmul(xf.float(), p.router.float())
    return collectives.gather(logits, -1, p.tp) if p.partial else logits


def positions_in_expert(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, expert) pair's position within its expert, in the order
    of a stable sort by expert id (flat order within an expert)."""
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.zeros(E, dtype=torch.int64, device=e_flat.device).index_add_(
        0, e_sorted, torch.ones_like(e_sorted))
    starts = torch.cumsum(counts, 0) - counts                # (E,)
    pos_sorted = torch.arange(e_flat.numel(), device=e_flat.device) - starts[e_sorted]
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def _global_positions(p: MoE, idx: torch.Tensor, pos: torch.Tensor, E: int):
    """A data rank's pairs' positions among the global batch's (the data
    ranks' rows in rank order), and the global token count's factor:
    each pair moves past the pairs of its expert on the ranks before."""
    counts = torch.zeros(E, dtype=torch.int64, device=idx.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.int64, device=idx.device))
    every = p.dp.gather(counts[None], 0)                     # (dp, E)
    before = every[:p.dp.rank].sum(0)
    return pos + before[idx], p.dp.size


def _moe_tokens(p: MoE, xf: torch.Tensor, cfg: ModelConfig, block: bool = False
                ) -> torch.Tensor:
    """The routed experts of tokens ``xf`` (T, d), capacity over these T
    (over the global batch's tokens on a data rank, unless ``block``):
    route, position in expert, dispatch, expert FFN, combine.  A shard
    routes over all E experts, dispatches the pairs of its own experts
    and returns its fp32 partial sum."""
    T, d = xf.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    if p.partial:
        xf = collectives.copy(xf, p.tp)
    weights, idx = route(router_logits(p, xf), k)          # (T, k) each

    pos = positions_in_expert(idx.reshape(-1), E).reshape(T, k)
    ranks = 1
    if p.dp is not None and not block:
        pos, ranks = _global_positions(p, idx, pos, E)
    C = capacity(T * ranks, E, k, cfg.moe_capacity_factor)
    keep = pos < C
    if _Routing.log is not None:
        _Routing.log.append((idx, keep))

    # the rank's experts: first .. first + E_local - 1 (all of them
    # without tensor parallelism); another rank's pair takes the drop bin
    # of local expert 0 and a zero gate
    E_local = p.wg.shape[0]
    first = p.tp.rank * E_local if p.partial else 0
    local = idx - first
    if p.partial:
        mine = (local >= 0) & (local < E_local)
        keep = keep & mine
        local = torch.where(mine, local, 0)

    # dispatch: each pair's token into (E_local, C + 1, d); positions are
    # unique per (expert, slot), and row C is the drop bin, never read
    buf = torch.zeros(E_local, C + 1, d, dtype=xf.dtype, device=xf.device)
    buf[local, torch.where(keep, pos, C)] = xf[:, None, :]
    buf = buf[:, :C]

    # the expert FFN over every (local) expert
    h = act_fn(cfg.mlp_act)(torch.bmm(buf, p.wg)) * torch.bmm(buf, p.wu)
    y = torch.bmm(h, p.wd)                                   # (E_local, C, d)

    # combine: gather back, gates zero for a dropped or another rank's
    # pair (whose gathered row is some other pair's), sum over k; in the
    # activations' dtype, or a shard's fp32 partial
    yk = y[local, pos.clamp(max=C - 1)]                      # (T, k, d)
    if p.partial:
        weights = collectives.copy(weights, p.tp)
    gates = torch.where(keep, weights, 0)
    if p.partial:
        return torch.sum(yk.float() * gates[..., None], dim=1)
    return torch.sum(yk * gates.to(xf.dtype)[..., None], dim=1)


def moe_parts(p: MoE, x: torch.Tensor, cfg: ModelConfig, blocks: int = 0
              ) -> List[Tuple[torch.Tensor, bool]]:
    """The layer's outputs (B, S, d), each with whether it is a partial
    sum over the ranks (fp32) or whole: the routed experts' (capacity over
    all B * S rows, or with ``blocks`` > 0 over each of ``apply_moe_blocked``'s
    blocks) and, where there is one, the shared MLP's."""
    B, S, d = x.shape
    if blocks:
        n = blocks
        if (B * S) % n or (B % n and n > 1):
            n = 1
        xf = x.reshape(n, B * S // n, d)
        routed = torch.cat([_moe_tokens(p, blk, cfg, block=True)
                            for blk in xf]).reshape(B, S, d)
    else:
        routed = _moe_tokens(p, x.reshape(B * S, d), cfg).reshape(B, S, d)
    parts = [(routed, p.partial)]
    if hasattr(p, "shared"):
        parts.append((apply_mlp(p.shared, x, cfg.mlp_act), p.shared.partial))
    return parts


def _sum(parts) -> torch.Tensor:
    return functools.reduce(torch.add, (t for t, _ in parts))


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, parts: bool = False):
    """x (B, S, d) -> (B, S, d); the capacity counts all B * S rows.  The
    routed and shared outputs summed (a shard's fp32 partials where both
    are split), or with ``parts`` each with its kind (``moe_parts``)."""
    out = moe_parts(p, x, cfg)
    return out if parts else _sum(out)


def apply_moe_blocked(p: MoE, x: torch.Tensor, cfg: ModelConfig,
                      shards: int = 1, parts: bool = False):
    """Block-local dispatch: the tokens in ``shards`` equal blocks, each
    routed with its own capacity, as the reference's ``apply_moe_blocked``
    does with one block per data shard of its mesh.  The port has no mesh,
    so the caller gives the count; an uneven split falls back to one
    block, as the reference's does.  ``parts`` as ``apply_moe``'s."""
    out = moe_parts(p, x, cfg, blocks=shards)
    return out if parts else _sum(out)


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: E * sum over experts of
    (fraction of tokens whose top-1 is the expert) * (mean probability)."""
    probs = torch.softmax(logits.float(), dim=-1)            # (T, E)
    top1 = torch.zeros_like(probs).scatter_(1, idx[:, :1], 1.0)
    return E * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
