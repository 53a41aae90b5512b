"""KV-cache size profiling (paper §2.2, Table 2), the counterpart of
``repro/core/cache.py``.

The report counts the cache that ``Model.init_cache`` would allocate for a
(batch, seq_len) workload, built on the ``meta`` device, leaf by leaf as
the reference's ``_classify`` files them: K/V (``k``, ``v``, ``kp``,
``vp``) is ``kv``, the encoder memory's K/V (``cross_k``, ``cross_v``) is
``cross``, position bookkeeping (``pos``, ``ring``) is ``meta``, recurrent
states (RG-LRU, mLSTM and sLSTM leaves) are ``state``.  ``cross_pos``, the
port's mask over the memory rows, has no counterpart in the reference,
whose memory is as long as it is filled; it is left out, so the two
reports agree byte for byte.  ``analytic_kv_bytes`` and ``paged_kv_bytes``
are the reference's closed forms of the contiguous and the paged KV.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import units
from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class CacheReport:
    name: str
    batch: int
    seq_len: int
    total_bytes: int
    kv_bytes: int           # self-attention KV
    state_bytes: int        # recurrent states (RG-LRU, mLSTM, sLSTM)
    cross_bytes: int        # encoder-decoder cross-attention memory
    meta_bytes: int         # position bookkeeping
    by_kind: Dict[str, int]

    def fmt(self, unit: str = "GB") -> str:
        f = lambda b: units.fmt_bytes(b, unit)
        return (
            f"{self.name} cache @ batch={self.batch}, L={self.seq_len}: "
            f"total {f(self.total_bytes)} "
            f"(kv {f(self.kv_bytes)}, state {f(self.state_bytes)}, "
            f"cross {f(self.cross_bytes)})"
        )


def _classify(leaf: str) -> str:
    if leaf in ("cross_k", "cross_v"):
        return "cross"
    if leaf in ("pos", "ring"):
        return "meta"
    if leaf in ("k", "v", "kp", "vp"):
        return "kv"
    return "state"


def profile_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, *,
                  layout: str = "contiguous", block_size: int = 16,
                  num_blocks: int = 0) -> CacheReport:
    """The cache of ``batch`` rows of ``seq_len`` in ``layout``: a paged
    cache's full-context layers hold a pool of ``num_blocks`` x
    ``block_size`` (0: the worst case, every row's blocks and the garbage
    block), its pool leaves ``kp``/``vp`` counted as ``kv``."""
    dtype = dtype or getattr(torch, cfg.dtype)
    by_kind: Dict[str, int] = {"kv": 0, "state": 0, "cross": 0, "meta": 0}
    for entry in cache_lib.init_cache(cfg, batch, seq_len, dtype, "meta", layout=layout,
                                      block_size=block_size, num_blocks=num_blocks):
        for leaf, t in entry.items():
            if leaf != "cross_pos":
                by_kind[_classify(leaf)] += t.numel() * t.element_size()
    return CacheReport(
        name=cfg.name, batch=batch, seq_len=seq_len,
        total_bytes=sum(by_kind.values()),
        kv_bytes=by_kind["kv"], state_bytes=by_kind["state"],
        cross_bytes=by_kind["cross"], meta_bytes=by_kind["meta"],
        by_kind=by_kind,
    )


def analytic_kv_bytes(cfg: ModelConfig, batch: int, seq_len: int,
                      itemsize: int = 2) -> int:
    """Closed-form attention-KV bytes: the cross-check for
    ``profile_cache`` and the formula of the paper's Table 2."""
    total = 0
    for kind in cfg.blocks():
        if kind == "attn":
            length = seq_len
        elif kind == "local_attn":
            length = min(cfg.sliding_window, seq_len)
        else:
            continue
        total += 2 * batch * length * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize
    return total


def paged_kv_bytes(cfg: ModelConfig, lengths, block_size: int,
                   itemsize: int = 2, max_len: int = 0) -> int:
    """Attention-KV bytes a paged cache allocates for per-request token
    counts ``lengths`` (prompt + generated): a full-context layer takes
    ``ceil(len / block_size)`` pool blocks per request, a sliding-window
    layer keeps its ring of ``min(window, max_len)`` per resident request
    whatever its length (paging does not change rings).  The contiguous
    worst case to compare with is ``analytic_kv_bytes(cfg, len(lengths),
    max_len)``."""
    max_len = max_len or max((int(n) for n in lengths), default=0)
    per_tok = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize
    blocks = sum(-(-int(n) // block_size) for n in lengths)
    total = 0
    for kind in cfg.blocks():
        if kind == "attn":
            total += blocks * block_size * per_tok
        elif kind == "local_attn":
            total += len(lengths) * min(cfg.sliding_window, max_len) * per_tok
    return total
