"""Tensor-parallel serving rules, the counterpart of
``repro/sharding/rules.py``: ``TP_SERVE_RULES`` and the divisibility rule
of ``logical_to_pspec``.

The reference names every parameter dim by a logical axis and maps
``heads``, ``kv_heads``, ``ffn`` and ``vocab`` onto the ``tp`` mesh axis;
batch, slot state and sampling state replicate.  The port shards by hand
(Megatron-style): each parameter leaf names the one dim that shards, the
rank keeps its contiguous slice of it, and the model calls a collective
where the reference has a sharding constraint (``models/model.py``,
``models/layers.py``).  A dim shards only if ``tp`` divides it, as in the
reference; where one of the four does not, the model is refused with the
dim named, since a replicated head or a padded shard is a different
layout from the one the reference's serving rules give.

This slice shards the dense decoders: attention and FFN blocks, the
parallel block, tied or untied tables.  The other families are refused at
tp > 1 (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig

# parameter leaf -> (the dim that shards over tp, its logical axis); the
# norms' ``scale`` replicates
TP_SERVE_RULES: Dict[str, Tuple[int, str]] = {
    "wq": (1, "heads"), "bq": (0, "heads"), "wo": (0, "heads"),
    "wk": (1, "kv_heads"), "wv": (1, "kv_heads"), "bk": (0, "kv_heads"), "bv": (0, "kv_heads"),
    "wg": (1, "ffn"), "wu": (1, "ffn"), "wd": (0, "ffn"),
    "table": (0, "vocab"),       # the input table, and the output logits it gives
}

# the block kinds a tensor-parallel model may hold
TP_BLOCKS = ("attn", "ffn")

# logical axis -> the config field that sizes it
AXIS_FIELDS = {"heads": "num_heads", "kv_heads": "num_kv_heads", "ffn": "d_ff",
               "vocab": "vocab_size"}


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise ``ValueError`` unless ``cfg`` can be served at ``tp``: a dense
    attention + FFN decoder whose heads, KV heads, FFN hidden and
    vocabulary ``tp`` all divide."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return
    unported = []
    if cfg.is_moe:
        unported.append("mixture-of-experts layers")
    if cfg.is_encdec:
        unported.append("an encoder and cross attention")
    if cfg.num_vision_tokens:
        unported.append("a vision prefix")
    kinds = sorted({k for k in cfg.blocks() if k not in TP_BLOCKS})
    if kinds:
        unported.append(f"{', '.join(kinds)} blocks")
    if unported:
        raise ValueError(
            f"{cfg.name}: tensor parallelism shards dense attention + FFN decoders only; "
            f"tp={tp} refuses {' and '.join(unported)} (ROADMAP queue 1)")
    for axis, field in AXIS_FIELDS.items():
        n = getattr(cfg, field)
        if n % tp:
            raise ValueError(f"{cfg.name}: tp={tp} does not divide {axis} ({field}={n}), "
                             f"so it cannot shard over tp")


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config of one rank's shard: heads, KV heads, FFN hidden and
    vocabulary divided by ``tp``, the head dim kept."""
    check_tp(cfg, tp)
    if tp == 1:
        return cfg
    return cfg.replace(num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                       head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff // tp,
                       vocab_size=cfg.vocab_size // tp)


def shard_dim(name: str, shape, tp: int) -> Optional[int]:
    """The dim of parameter ``name`` (a dotted path) that shards over
    ``tp``: its rule's, if ``tp`` divides it (the reference's rule), else
    None (replicated)."""
    rule = TP_SERVE_RULES.get(name.rsplit(".", 1)[-1])
    if tp == 1 or rule is None or shape[rule[0]] % tp:
        return None
    return rule[0]


def local_slice(name: str, full, rank: int, tp: int):
    """Rank ``rank``'s slice of the full parameter ``full`` (a tensor or an
    array): the ``rank``-th of ``tp`` equal parts of its sharded dim."""
    dim = shard_dim(name, full.shape, tp)
    if dim is None:
        return full
    n = full.shape[dim] // tp
    index = [slice(None)] * len(full.shape)
    index[dim] = slice(rank * n, (rank + 1) * n)
    return full[tuple(index)]
