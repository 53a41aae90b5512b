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
reports agree byte for byte.
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


def profile_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None) -> CacheReport:
    dtype = dtype or getattr(torch, cfg.dtype)
    by_kind: Dict[str, int] = {"kv": 0, "state": 0, "cross": 0, "meta": 0}
    for kind in cfg.blocks():
        entry = cache_lib.init_block_cache(cfg, kind, batch, seq_len, dtype, "meta")
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
