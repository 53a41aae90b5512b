"""Placing a model on a mesh, the counterpart of
``repro/sharding/partition.py`` (``param_shardings``,
``opt_state_shardings``, ``batch_shardings``, ``cache_shardings``).

``shard_model(cfg, mesh, seed)`` gives one rank its shard with random
weights: every parameter is drawn at its full shape, in the order
``models.model.init`` draws them, from the same seeded generator, one
module at a time; the rank keeps its slice (``Placement.slice``, by the
rule of the module that owns the leaf: a MoE layer's experts and router
columns, its shared MLP's hidden, an RG-LRU's width and gate rows, an
mLSTM's width and block-diagonal rows, an sLSTM's FFN) and drops the
rest; a leaf whose sharded dim tp does not divide stays whole.  So the
shards of tp = N are exactly the weights of tp = 1 (an RG-LRU's fixed
``lambda`` too, drawn at full width and sliced), and a rank holds at most
one module's full parameters beyond its shard.  Where ranks share a
device (``TPMesh.shared``) they draw in turn, so only one full module is
on the device at a time.

The cache needs no placement: the rank's model makes it
(``Model.init_cache``), each leaf cut as the reference's
``cache_shardings`` cuts it on a ``tp`` mesh (``rules.cache_dim``).
Contiguous K/V hold the rank's KV heads, or, where tp does not divide
them, its slots ``[r·L/tp, (r+1)·L/tp)`` of every head (L-sharded; ``pos``
whole), or everything where tp divides neither.  A paged pool holds the
rank's KV heads, else every head (replicated); its block axis is always
whole, so the host-managed block tables index every rank's pool alike.
Recurrent states hold their heads or width.

On a ``("data", "model")`` training mesh (``launch.mesh.Mesh``) a rank's
parameter is its 2-D slice: the model slice above, then its data shard
along the leaf's ``embed`` dim (``rules.data_dim``), as ``param_pspecs``
under ``DEFAULT_RULES`` places it.  ``Placement`` holds every leaf's two
dims and slices, gathers and classifies by them; ``shard_model`` draws a
rank's 2-D shard, ``shard_params`` places a full state dict (bridged from
the reference, or restored from a checkpoint: the elastic restore),
``gather_params`` brings the whole state dict to rank 0, and
``batch_rows`` is a rank's rows of a batch (``batch_shardings``).  The
moments shard like their parameters (``opt_state_shardings``).  A prefill
or decode step on such a rank takes ``rank_rows`` of the global batch
(which also points a MoE layer at the global batch) and ``rank_cache``
(the batch dim over data where dp divides it, as the reference's
``cache_shardings`` on that mesh).  On a mesh of pods a leaf that the
whole data axis does not divide splits over the pods
(``rules.data_split``, ``Placement.data_axis``).  A decode step under the
serve rules takes the same arguments, as the reference's ``SERVE_RULES``
keeps the parameter and cache shardings, but for the norm scales, which
it splits over data (``Placement(serve=True)``; a rank that also runs a
prefill under FSDP keeps them whole and reads its slice); its residual
stream splits as the weights' ``embed`` dim does
(``Placement.residual_split``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.bridge import as_tensor
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.sharding.fsdp import FSDP
from repro_torch.sharding.rules import (
    check_tp, data_split, leaf_rule, local_shape, rank_slice, shard_dim,
)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter's full shape, the dims that split over the model and
    data axes (None: whole over that axis), and the data dim's parts: dp,
    or the pods where dp does not divide it (``rules.data_split``)."""
    shape: Tuple[int, ...]
    model_dim: Optional[int]
    data_dim: Optional[int]
    data_parts: int = 1


class Placement:
    """Where each parameter of ``cfg`` lives on ``mesh``: a
    ``launch.mesh.Mesh`` of (dp, tp) ranks, or a ``TPMesh`` (dp = 1).
    ``serve``: under the serve rules, the norm scales split over data too
    (``rules.SERVE_DATA_DIMS``)."""

    def __init__(self, cfg: ModelConfig, mesh, serve: bool = False):
        self.cfg, self.mesh = cfg, mesh
        self.data = getattr(mesh, "data", None)
        self.model = getattr(mesh, "model", mesh)
        self.dp = self.data.size if self.data is not None else 1
        self.tp = self.model.size
        self.pods = getattr(mesh, "pods", 1)
        full = Model(cfg, device="meta")  # the full shapes, no memory
        self.leaves: Dict[str, Leaf] = {}
        for prefix, module in full.named_modules():
            for leaf, p in module.named_parameters(recurse=False):
                shape = tuple(p.shape)
                self.leaves[f"{prefix}.{leaf}" if prefix else leaf] = Leaf(
                    shape, shard_dim(leaf_rule(module, leaf), shape, self.tp),
                    *data_split(module, leaf, shape, self.dp, self.pods, serve))

    def shape(self, name: str) -> Tuple[int, ...]:
        """The rank's shape of parameter ``name``."""
        leaf = self.leaves[name]
        return local_shape(local_shape(leaf.shape, leaf.model_dim, self.tp),
                           leaf.data_dim, leaf.data_parts)

    def data_axis(self, name: str):
        """The axis parameter ``name``'s data dim splits over: the data
        axis, or the pod axis where only the pods divide it."""
        return self.data if self.leaves[name].data_parts == self.dp else self.mesh.pod

    def slice(self, name: str, full):
        """The rank's slice of the full parameter ``name`` (a tensor or an
        array of its full shape)."""
        leaf = self.leaves[name]
        part = rank_slice(full, leaf.model_dim, self.model.rank, self.tp)
        if leaf.data_dim is None:
            return part
        return rank_slice(part, leaf.data_dim, self.data_axis(name).rank, leaf.data_parts)

    def sharded(self, name: str) -> Tuple[bool, bool]:
        """Whether parameter ``name`` splits over (data, model)."""
        leaf = self.leaves[name]
        return leaf.data_dim is not None, leaf.model_dim is not None

    def residual_split(self):
        """(the axis the residual stream's width splits over in a decode
        step under the serve rules, into how many parts): the split of the
        weights' ``embed`` dim, which is ``d_model`` in every leaf that has
        one (the embedding table's, read here): the data axis, or the pod
        axis where only the pods divide it; (None, 1) where it is whole."""
        name = "embed.table"
        leaf = self.leaves[name]
        if leaf.data_dim is None:
            return None, 1
        return self.data_axis(name), leaf.data_parts

    def data_replicas(self, name: str) -> int:
        """How many data ranks hold the same data shard of ``name``: 1 where
        it splits over the data axis, dp / pods over the pods, dp whole."""
        return self.dp // self.leaves[name].data_parts

    def gather(self, name: str, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The full parameter ``name`` (or a gradient or moment of it) on
        the host of the mesh's rank 0, None on the others, from every
        rank's slice ``t``: over data to each model index's data rank 0,
        then over model among those.  Every rank calls it.  Always a new
        tensor, never the live one of a leaf whole on every rank."""
        leaf, src = self.leaves[name], t.detach()
        t = src
        if leaf.data_dim is not None and self.data_replicas(name) > 1:
            # over the pods, in every pod group alike; then data rank 0's
            t = self.mesh.pod.gather_root(t, leaf.data_dim)
            if self.data.rank != 0:
                return None
        elif self.data is not None:
            if self.data.rank != 0:
                if leaf.data_dim is not None:
                    self.data.gather_root(t, leaf.data_dim)
                return None
            if leaf.data_dim is not None:
                t = self.data.gather_root(t, leaf.data_dim)
        if self.model.rank != 0:
            if leaf.model_dim is not None:
                self.model.gather_root(t, leaf.model_dim)
            return None
        if leaf.model_dim is not None:
            t = self.model.gather_root(t, leaf.model_dim)
        return t.to("cpu", copy=True) if t is src else t.cpu()


def _materialize(model: Model, placement: Placement, device) -> None:
    """Give each of ``model``'s parameters (built on meta) the rank's
    storage on ``device``."""
    dtypes = {name: p.dtype for name, p in model.named_parameters()}
    for prefix, module in model.named_modules():
        for leaf in list(module._parameters):
            name = f"{prefix}.{leaf}" if prefix else leaf
            module._parameters[leaf] = nn.Parameter(
                torch.empty(placement.shape(name), dtype=dtypes[name], device=device),
                requires_grad=False)


def _rank_model(cfg: ModelConfig, mesh, serve: bool = False) -> Model:
    """A rank's model of the 2-D ``mesh``, its storage empty, with its
    ``placement`` (``serve``: under the serve rules) and, where data
    splits anything, its FSDP."""
    placement = Placement(cfg, mesh, serve)
    model = Model(cfg, device="meta", mesh=mesh.model if mesh.model.size > 1 else None)
    _materialize(model, placement, mesh.device)
    model.placement = placement
    model.fsdp = FSDP(model, mesh.data, {
        name: None if leaf.data_dim is None else (leaf.data_dim, placement.data_axis(name))
        for name, leaf in placement.leaves.items()})
    return model


@torch.no_grad()
def _draw(model: Model, cfg: ModelConfig, mesh, seed: int) -> None:
    full = Model(cfg, device="meta")  # the full shapes, no memory
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    names = {id(m): prefix for prefix, m in full.named_modules()}
    for whole, part in zip(full.modules(), model.modules()):
        if not hasattr(whole, "init_"):
            continue
        whole.to_empty(device=mesh.device, recurse=False)
        whole.init_(gen)
        prefix = names[id(whole)]
        for (name, p_full), p in zip(whole.named_parameters(recurse=False),
                                     part.parameters(recurse=False)):
            p.copy_(model.placement.slice(f"{prefix}.{name}" if prefix else name, p_full))
        whole.to_empty(device="meta", recurse=False)


def _in_turn(mesh, fn) -> None:
    """``fn()`` on every rank; in turn where ranks share a device, so only
    one full module is on it at a time."""
    if not mesh.shared:
        fn()
        return
    for turn in range(mesh.size):
        if turn == mesh.rank:
            fn()
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
                torch.cuda.empty_cache()
        mesh.barrier()


def shard_model(cfg: ModelConfig, mesh, seed: int = 0) -> Model:
    """Rank ``mesh.rank``'s shard of ``cfg`` on ``mesh.device``, the slices
    of ``models.model.init(cfg, torch.Generator(device).manual_seed(seed),
    device)``: on a ``TPMesh`` its model slice, on a 2-D ``Mesh`` its 2-D
    slice with the model's ``fsdp`` set; the model's ``placement`` either
    way.  Refuses (``ValueError``) what
    ``rules.check_train_tp`` refuses on a training mesh and what
    ``rules.check_tp`` refuses on a serving ``TPMesh`` (an encoder too)."""
    if hasattr(mesh, "data"):
        model = _rank_model(cfg, mesh)
    else:
        check_tp(cfg, mesh.size)
        model = Model(cfg, device=mesh.device, mesh=mesh)
        model.placement = Placement(cfg, mesh)
    _in_turn(mesh, lambda: _draw(model, cfg, mesh, seed))
    return model


@torch.no_grad()
def shard_params(cfg: ModelConfig, full: Mapping[str, object], mesh) -> Model:
    """A rank's model of the 2-D ``mesh`` holding its slices of ``full``
    (the port's parameter names -> full tensors or arrays): parameters
    bridged from the reference, or restored from a checkpoint written
    under any mesh."""
    model = _rank_model(cfg, mesh)
    params = dict(model.named_parameters())
    if set(full) != set(params):
        raise ValueError(f"parameter names differ: {sorted(set(full) ^ set(params))}")
    for name, p in params.items():
        src = model.placement.slice(name, full[name])
        p.copy_(as_tensor(src) if isinstance(src, np.ndarray) else src)
    return model


def gather_params(tensors: Mapping[str, torch.Tensor], placement: Placement
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """The full tensors of a rank's ``tensors`` (parameters, or their
    gradients or moments, by parameter name) on the host of rank 0, None
    elsewhere; every rank must call it."""
    out = {name: placement.gather(name, t) for name, t in tensors.items()}
    return out if placement.mesh.rank == 0 else None


def batch_rows(batch: Mapping[str, torch.Tensor], mesh) -> Tuple[Dict, bool]:
    """The rank's rows of ``batch`` and whether they are a split of it:
    each leaf's dim 0 split over the data ranks where data divides it,
    else the whole batch on every rank (``batch_shardings``)."""
    dp = mesh.data.size
    B = next(iter(batch.values())).shape[0]
    if dp <= 1 or B % dp:
        return dict(batch), False
    n = B // dp
    return {k: v[mesh.data.rank * n:(mesh.data.rank + 1) * n] for k, v in batch.items()}, True


def rank_rows(model: Model, batch: Mapping[str, torch.Tensor]) -> Dict:
    """The rank's rows of ``batch`` (a prefill's inputs, or a decode step's
    ``token`` and ``positions``) for ``model``, a rank's shard of a 2-D
    mesh, its FSDP told whether they split the batch (so a MoE layer
    routes the global batch, as in training, and a decode step under the
    serve rules gathers them whole); the batch itself for a model without
    FSDP."""
    if model.fsdp is None:
        return dict(batch)
    rows, summed = batch_rows(batch, model.placement.mesh)
    model.fsdp.set_rows(summed)
    return rows


def rank_cache(model: Model, batch: int, max_len: int, dtype=None, **layout):
    """The rank's cache for a global batch of ``batch`` rows, the
    reference's ``cache_shardings`` on the (data, model) mesh: the batch
    dim over data where dp divides it (else whole), each leaf's model dim
    by ``rules.cache_dim``; ``Model.init_cache`` for a model without
    FSDP."""
    dp = model.placement.mesh.data.size if model.fsdp is not None else 1
    if dp > 1 and batch % dp == 0:  # as ``batch_rows`` splits the rows
        batch //= dp
    return model.init_cache(batch, max_len, dtype, **layout)
