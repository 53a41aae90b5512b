"""Tensor-parallel serving rules, the counterpart of
``repro/sharding/rules.py``: ``TP_SERVE_RULES`` and the divisibility rule
of ``logical_to_pspec``.

The reference names every parameter dim by a logical axis and maps
``heads``, ``kv_heads``, ``ffn``, ``experts`` and ``vocab`` onto the
``tp`` mesh axis; ``expert_ffn``, batch, slot state and sampling state
replicate.  The port shards by hand (Megatron-style): each parameter leaf
names the one dim that shards, the rank keeps its contiguous slice of it,
and the model calls a collective where the reference has a sharding
constraint (``models/model.py``, ``models/layers.py``, ``models/moe.py``).
A leaf's rule is found from the module that owns it, since one leaf name
can mean two layouts: a dense MLP's ``wg`` is (d, ff) and shards ``ffn``
on dim 1, an expert stack's ``wg`` is (E, d, ff) and shards ``experts`` on
dim 0, and moonshot's shared MLP inside the MoE layer is a dense MLP.  A
dim shards only if ``tp`` divides it, as in the reference; where one does
not, the model is refused with the dim named, since a replicated head or
a padded shard is a different layout from the one the reference's serving
rules give.

This slice shards the dense decoders (attention and FFN blocks, the
parallel block, tied or untied tables), the mixture-of-experts layer (the
router's expert columns and the expert stacks over ``experts``, the
shared MLP over ``ffn``) and a vision prefix (the patch embeddings are an
input, replicated on every rank).  RG-LRU and xLSTM blocks, an encoder,
and a dim ``tp`` does not divide are refused at tp > 1 (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig

# a leaf's rule: (the dim that shards over tp, its logical axis)
Rule = Tuple[int, str]

# owning module's class -> parameter leaf -> rule; a leaf without one (the
# norms' ``scale``) replicates
TP_SERVE_RULES: Dict[str, Dict[str, Rule]] = {
    "Attention": {"wq": (1, "heads"), "bq": (0, "heads"), "wo": (0, "heads"),
                  "wk": (1, "kv_heads"), "wv": (1, "kv_heads"), "bk": (0, "kv_heads"),
                  "bv": (0, "kv_heads")},
    "MLP": {"wg": (1, "ffn"), "wu": (1, "ffn"), "wd": (0, "ffn")},
    # the routed experts' hidden (``expert_ffn``) never shards
    "MoE": {"router": (1, "experts"), "wg": (0, "experts"), "wu": (0, "experts"),
            "wd": (0, "experts")},
    "Embedding": {"table": (0, "vocab")},  # the input table, and the logits it gives
}

# the block kinds a tensor-parallel model may hold
TP_BLOCKS = ("attn", "ffn")


def sharded_dims(cfg: ModelConfig) -> Dict[str, Tuple[str, int]]:
    """Each logical axis that shards in ``cfg`` -> (the config field, or
    product of fields, that sizes it; its size)."""
    dims = {"heads": ("num_heads", cfg.num_heads),
            "kv_heads": ("num_kv_heads", cfg.num_kv_heads),
            "vocab": ("vocab_size", cfg.vocab_size)}
    if not cfg.is_moe:  # a dense MLP of d_ff
        dims["ffn"] = ("d_ff", cfg.d_ff)
    else:
        dims["experts"] = ("num_experts", cfg.num_experts)
        if cfg.num_shared_experts:
            dims["shared ffn"] = ("d_ff * num_shared_experts",
                                  cfg.d_ff * cfg.num_shared_experts)
    return dims


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise ``ValueError`` unless ``cfg`` can be served at ``tp``: a
    decoder of attention (dense MLP or mixture-of-experts) and FFN blocks,
    with or without a vision prefix, whose sharded dims ``tp`` all
    divides."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return
    unported = []
    if cfg.is_encdec:
        unported.append("an encoder and cross attention")
    kinds = sorted({k for k in cfg.blocks() if k not in TP_BLOCKS})
    if kinds:
        unported.append(f"{', '.join(kinds)} blocks")
    elif cfg.is_moe and "ffn" in cfg.blocks():
        unported.append("ffn blocks beside mixture-of-experts layers")
    if unported:
        raise ValueError(
            f"{cfg.name}: tensor parallelism shards attention + FFN decoders (dense or "
            f"mixture-of-experts MLPs, with or without a vision prefix) only; tp={tp} "
            f"refuses {' and '.join(unported)} (ROADMAP queue 1)")
    for axis, (field, n) in sharded_dims(cfg).items():
        if n % tp:
            raise ValueError(f"{cfg.name}: tp={tp} does not divide {axis} ({field}={n}), "
                             f"so it cannot shard over tp")


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config of one rank's shard: heads, KV heads, the dense FFN
    hidden and vocabulary divided by ``tp``, the head dim kept.  A
    mixture-of-experts config keeps ``num_experts`` and ``d_ff`` whole:
    every rank routes over all E experts with the capacity of tp = 1, and
    the experts' hidden does not shard; its layer takes the shard count
    itself (``models.moe.MoE``)."""
    check_tp(cfg, tp)
    if tp == 1:
        return cfg
    return cfg.replace(num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                       head_dim=cfg.resolved_head_dim,
                       d_ff=cfg.d_ff if cfg.is_moe else cfg.d_ff // tp,
                       vocab_size=cfg.vocab_size // tp)


def leaf_rule(module, leaf: str) -> Optional[Rule]:
    """The rule of parameter ``leaf`` of ``module``, by the module's class
    (None: it replicates)."""
    return TP_SERVE_RULES.get(type(module).__name__, {}).get(leaf)


def param_rules(model) -> Dict[str, Optional[Rule]]:
    """Every parameter of ``model`` (an ``nn.Module``) by its dotted name ->
    its rule, found from the module that owns it."""
    out = {}
    for prefix, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            out[f"{prefix}.{leaf}" if prefix else leaf] = leaf_rule(module, leaf)
    return out


def shard_dim(rule: Optional[Rule], shape, tp: int) -> Optional[int]:
    """The dim of a parameter of ``shape`` that shards over ``tp`` by its
    ``rule`` (None: replicated).  A dim ``tp`` does not divide raises, as
    ``check_tp`` refuses its config: it is never padded or replicated."""
    if tp == 1 or rule is None:
        return None
    dim, axis = rule
    if shape[dim] % tp:
        raise ValueError(f"tp={tp} does not divide dim {dim} ({axis}) of a parameter of "
                         f"shape {tuple(shape)}")
    return dim


def local_slice(rule: Optional[Rule], full, rank: int, tp: int):
    """Rank ``rank``'s slice of the full parameter ``full`` (a tensor or an
    array) whose rule is ``rule``: the ``rank``-th of ``tp`` equal parts of
    its sharded dim."""
    dim = shard_dim(rule, full.shape, tp)
    if dim is None:
        return full
    n = full.shape[dim] // tp
    index = [slice(None)] * len(full.shape)
    index[dim] = slice(rank * n, (rank + 1) * n)
    return full[tuple(index)]
