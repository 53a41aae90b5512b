"""Tensor-parallel serving rules and the training mesh's rules, the
counterpart of ``repro/sharding/rules.py``: ``TP_SERVE_RULES`` and
``DEFAULT_RULES``, the divisibility rule of ``logical_to_pspec`` and the
cache layout of ``partition.cache_shardings``.

The reference names every parameter dim by a logical axis and maps
``heads``, ``kv_heads``, ``ffn``, ``experts``, ``lru`` and ``vocab`` onto
the ``tp`` mesh axis; ``expert_ffn``, ``embed``, batch, slot state and
sampling state replicate.  The port shards by hand (Megatron-style): each
parameter leaf names the one dim that shards, the rank keeps its
contiguous slice of it, and the model calls a collective where the
reference has a sharding constraint (``models/model.py``,
``models/layers.py``, ``models/moe.py``, ``models/recurrent.py``,
``models/attention.py``).  A leaf's rule is found from the module that
owns it, since one leaf name can mean two layouts: a dense MLP's ``wg`` is
(d, ff) and shards ``ffn`` on dim 1, an expert stack's ``wg`` is (E, d,
ff) and shards ``experts`` on dim 0, and an RG-LRU's ``conv_w`` shards
``lru`` where an sLSTM's replicates.

A dim shards only if ``tp`` divides it; where it does not, the leaf is
whole on every rank, as ``logical_to_pspec`` drops the mapping
(``shard_dim``).  So each module takes the shard count and decides for
itself what is sharded and what is whole (``local_size``); a branch whose
weights are whole gives a whole output, which the model adds after the
reduce of the partial ones.  The cache follows ``cache_shardings``
(``cache_dim``): contiguous K/V on the KV heads, else on the cache length
L, else replicated; a paged pool on the heads, else replicated; recurrent
states on their heads or width.

Training (``DEFAULT_RULES`` on a ``("data", "model")`` mesh) keeps those
model dims and adds each leaf's data dim (``DATA_DIMS``): the dim the
reference names ``embed``, which FSDP splits over the data ranks, or on a
mesh of several pods over the pods where the whole data axis does not
divide it (``data_split``).  The norm scales (``act_embed``), the block-diagonal
gates, the biases, the convolutions of a width and the recurrent ``r_*``
replicate over data; an sLSTM's ``norm_scale`` and ``conv_w`` are on
``embed`` and split.  Each axis is used once per leaf, the model and data
dims of a leaf always differ, and a dim the axis does not divide
replicates.  The encoder's attention and MLP and every decoder block's
``cross`` attention take the Attention and MLP rules.

``check_train_tp`` refuses a rank whose query heads straddle two KV
groups unevenly (tp divides the query heads, and neither of tp and the KV
heads divides the other); ``check_tp``, serving's check, refuses that and
an encoder, each by name: neither package's engine serves one.

The reference's weight-stationary decode (``SERVE_RULES``, ``--opt
serve_repl``) keeps every parameter and cache in its 2-D sharding and
changes only the activations: the batch replicated, the residual stream
split over data (``act_embed``), so each product contracts the rank's
slice of ``d`` on both mesh axes and every per-layer weight gather
becomes a small activation all-reduce.  ``use_serve_rules()`` is the
counterpart of ``rules.use_mesh(mesh, SERVE_RULES)``: a ``decode_step``
run inside it on a rank of a ``("data", "model")`` mesh takes that
layout (``models/model.py``); prefill, training and the engine's
``("tp",)`` mesh do not read it.  It covers the blocks of
``SERVE_BLOCKS`` (attention and a dense MLP); ``check_serve`` refuses the
others by name.  ``act_embed`` also names the norm scales, so under
those rules they split over data too (``SERVE_DATA_DIMS``), as the
residual stream does: where the weights' ``embed`` dim splits (over the
data axis, or the pods on a mesh of pods where the reference's bare
``"data"`` would not align with them).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.models.config import ModelConfig

# a leaf's rule: (the dim that shards over tp, its logical axis)
Rule = Tuple[int, str]

# owning module's class -> parameter leaf -> rule; a leaf without one (the
# norms' ``scale``, an sLSTM's gates) replicates
TP_SERVE_RULES: Dict[str, Dict[str, Rule]] = {
    "Attention": {"wq": (1, "heads"), "bq": (0, "heads"), "wo": (0, "heads"),
                  "wk": (1, "kv_heads"), "wv": (1, "kv_heads"), "bk": (0, "kv_heads"),
                  "bv": (0, "kv_heads")},
    "MLP": {"wg": (1, "ffn"), "wu": (1, "ffn"), "wd": (0, "ffn")},
    # the routed experts' hidden (``expert_ffn``) never shards
    "MoE": {"router": (1, "experts"), "wg": (0, "experts"), "wu": (0, "experts"),
            "wd": (0, "experts")},
    "Embedding": {"table": (0, "vocab")},  # the input table, and the logits it gives
    # the block-diagonal gates shard their input rows, every head's
    "RGLRU": {"in_x": (1, "lru"), "in_g": (1, "lru"), "conv_w": (1, "lru"),
              "gate_a": (1, "lru"), "gate_x": (1, "lru"), "lambda": (0, "lru"),
              "out": (0, "lru")},
    "MLSTM": {"up_u": (1, "ffn"), "up_z": (1, "ffn"), "conv_w": (1, "ffn"),
              "wq": (1, "ffn"), "wk": (1, "ffn"), "wv": (1, "ffn"), "w_i": (0, "ffn"),
              "w_f": (0, "ffn"), "norm_scale": (0, "ffn"), "down": (0, "ffn")},
    "SLSTM": {"ff_up": (1, "ffn"), "ff_down": (0, "ffn")},
}


# owning module's class -> parameter leaf -> its data dim (the reference's
# ``embed``), over which FSDP splits the leaf; a leaf without one replicates
# over data
DATA_DIMS: Dict[str, Dict[str, int]] = {
    "Attention": {"wq": 0, "wk": 0, "wv": 0, "wo": 2},
    "MLP": {"wg": 0, "wu": 0, "wd": 1},
    "MoE": {"router": 0, "wg": 1, "wu": 1, "wd": 2},
    "Embedding": {"table": 1},
    "RGLRU": {"in_x": 0, "in_g": 0, "out": 1},
    "MLSTM": {"up_u": 0, "up_z": 0, "down": 1},
    "SLSTM": {"w_z": 0, "w_i": 0, "w_f": 0, "w_o": 0, "conv_w": 1, "norm_scale": 0,
              "ff_up": 0, "ff_down": 1},
}


# the leaves the serve rules add to ``DATA_DIMS``: the norm scales (the
# reference's ``act_embed``), split over data as the residual stream is
SERVE_DATA_DIMS: Dict[str, Dict[str, int]] = {"Norm": {"scale": 0}}


def divides(tp: int, n: int) -> bool:
    """Whether a dim of ``n`` shards over ``tp`` > 1 ranks."""
    return tp > 1 and n % tp == 0


def local_size(n: int, tp: int) -> int:
    """A rank's share of a dim of ``n``: n / tp where tp divides it, else
    all of it (replicated)."""
    return n // tp if divides(tp, n) else n


def check_train_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise ``ValueError`` unless ``cfg`` shards over ``tp`` model ranks:
    any config (attention, local attention, FFN, mixture-of-experts,
    RG-LRU, mLSTM and sLSTM blocks, an encoder and cross attention, a
    vision prefix) whose ranks' query heads each read one KV group, or
    whole ones.  A dim tp does not divide is replicated."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if tp > 1 and divides(tp, hq) and not divides(tp, hkv) and tp % hkv:
        raise ValueError(
            f"{cfg.name}: tp={tp} gives each rank {hq // tp} of the {hq} query heads, which "
            f"straddle two groups of the {hkv} KV heads (G = {hq // hkv}) unevenly: a rank's "
            f"query heads must read one KV group, or whole ones")


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise ``ValueError`` unless ``cfg`` can be served at ``tp``: what
    ``check_train_tp`` accepts, but an encoder (no engine serves one)."""
    check_train_tp(cfg, tp)
    if tp > 1 and cfg.is_encdec:
        raise ValueError(
            f"{cfg.name}: tp={tp} refuses an encoder and cross attention: no engine serves "
            f"an encoder-decoder model (training shards it over the model axis)")


# the block kinds a decode step under the serve rules runs: attention (a
# cross attention too) and a dense MLP
SERVE_BLOCKS = ("attn", "local_attn", "ffn")


class ServeRefusal(ValueError):
    """A config with a block the serve rules do not cover yet."""


def check_serve(cfg: ModelConfig) -> None:
    """Raise ``ServeRefusal`` (a ``ValueError``) naming the block kinds of
    ``cfg`` that a decode step under the serve rules does not run: a
    mixture of experts, RG-LRU, mLSTM and sLSTM blocks."""
    kinds = ["moe"] if cfg.is_moe else []
    kinds += sorted({k for k in cfg.blocks() if k not in SERVE_BLOCKS})
    if kinds:
        raise ServeRefusal(
            f"{cfg.name}: --opt serve_repl (the weight-stationary decode) runs attention and "
            f"dense-MLP blocks; its {', '.join(kinds)} block(s) under the serve rules are "
            f"ROADMAP item 4d")


class _ServeState(threading.local):
    on = False


_SERVE = _ServeState()


@contextlib.contextmanager
def use_serve_rules() -> Iterator[None]:
    """Decode steps run inside take the serve rules (on this thread)."""
    prev, _SERVE.on = _SERVE.on, True
    try:
        yield
    finally:
        _SERVE.on = prev


def serve_rules() -> bool:
    """Whether the serve rules are on (``use_serve_rules``)."""
    return _SERVE.on


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
    ``rule``; None where it is replicated: no rule, tp = 1, or a dim tp
    does not divide (the reference's ``logical_to_pspec`` drops that
    mapping; a dim is never padded)."""
    if rule is None or not divides(tp, shape[rule[0]]):
        return None
    return rule[0]


def cache_dim(leaf: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim of a cache entry's ``leaf`` of full ``shape`` that shards
    over ``tp``, or None (replicated): the reference's ``cache_shardings``
    on a ``tp`` mesh for an entry with its batch on dim 0.  Contiguous
    ``k``/``v`` shard the KV heads, else the length L; the paged pool
    ``kp``/``vp`` its heads only; an RG-LRU's ``h`` (B, W) its width; the
    xLSTM states ``C``, ``n``, ``m``, ``c``, ``h`` their heads, else the
    dim after; ``conv`` its width; positions and flags replicate.  A dim
    shards where tp divides it and is at least tp."""
    if tp == 1:
        return None
    nd = len(shape)

    def first(*dims):
        for i in dims:
            if 0 <= i < nd and shape[i] % tp == 0 and shape[i] >= tp:
                return i
        return None

    if leaf in ("kp", "vp"):
        return first(nd - 2)
    if leaf in ("k", "v", "cross_k", "cross_v"):
        return first(nd - 2, 1)
    if leaf == "h" and nd == 2:
        return first(1)
    if leaf in ("C", "n", "m", "c", "h"):
        return first(1, 2)
    if leaf == "conv" and nd >= 3:
        return first(nd - 1)
    return None


def local_shape(shape: Sequence[int], dim: Optional[int], tp: int) -> Tuple[int, ...]:
    """``shape`` with dim ``dim`` cut to one of ``tp`` parts (None: whole)."""
    out = list(shape)
    if dim is not None:
        out[dim] //= tp
    return tuple(out)


def local_slice(rule: Optional[Rule], full, rank: int, tp: int):
    """Rank ``rank``'s slice of the full parameter ``full`` (a tensor or an
    array) whose rule is ``rule``: the ``rank``-th of ``tp`` equal parts of
    its sharded dim."""
    return rank_slice(full, shard_dim(rule, full.shape, tp), rank, tp)


def data_split(module, leaf: str, shape: Sequence[int], dp: int,
               pods: int = 1, serve: bool = False) -> Tuple[Optional[int], int]:
    """(the dim of ``module``'s parameter ``leaf`` of ``shape`` that splits
    over the data axis, into how many parts), by the module's class: over
    the ``dp`` data ranks where dp divides it; on a mesh of ``pods`` pods
    (the reference's data axes ``("pod", "data")``) where dp does not,
    over the pods where they divide it, as ``logical_to_pspec`` falls back
    to the first of the two axes that divides the dim (the pod axis:
    where 2 pods do not divide a dim, 16 data ranks do not either); else
    (None, 1), replicated over data (no data dim, dp = 1, or a dim
    neither divides).  ``serve``: under the serve rules, whose
    ``SERVE_DATA_DIMS`` add the norm scales."""
    name = type(module).__name__
    dim = DATA_DIMS.get(name, {}).get(leaf)
    if serve and dim is None:
        dim = SERVE_DATA_DIMS.get(name, {}).get(leaf)
    if dim is None:
        return None, 1
    for parts in (dp, pods):
        if divides(parts, shape[dim]):
            return dim, parts
    return None, 1


def rank_slice(t, dim: Optional[int], rank: int, parts: int):
    """The ``rank``-th of ``parts`` equal slices of ``t`` along ``dim`` (a
    tensor or an array; ``t`` itself where ``dim`` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // parts
    index = [slice(None)] * len(t.shape)
    index[dim] = slice(rank * n, (rank + 1) * n)
    return t[tuple(index)]
