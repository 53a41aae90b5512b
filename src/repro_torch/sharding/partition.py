"""Placing a tensor-parallel model, the counterpart of
``repro/sharding/partition.py`` (``param_shardings``, ``cache_shardings``).

``shard_model(cfg, mesh, seed)`` gives one rank its shard with random
weights: every parameter is drawn at its full shape, in the order
``models.model.init`` draws them, from the same seeded generator, one
module at a time; the rank keeps its slice (``rules.local_slice``, by the
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
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.sharding.rules import leaf_rule, local_slice


@torch.no_grad()
def _draw(model: Model, cfg: ModelConfig, mesh, seed: int) -> None:
    full = Model(cfg, device="meta")  # the full shapes, no memory
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    for whole, part in zip(full.modules(), model.modules()):
        if not hasattr(whole, "init_"):
            continue
        whole.to_empty(device=mesh.device, recurse=False)
        whole.init_(gen)
        for (name, p_full), p in zip(whole.named_parameters(recurse=False),
                                     part.parameters(recurse=False)):
            p.copy_(local_slice(leaf_rule(whole, name), p_full, mesh.rank, mesh.size))
        whole.to_empty(device="meta", recurse=False)


def shard_model(cfg: ModelConfig, mesh, seed: int = 0) -> Model:
    """Rank ``mesh.rank``'s shard of ``cfg`` on ``mesh.device``, the slices
    of ``models.model.init(cfg, torch.Generator(device).manual_seed(seed),
    device)``.  Refuses (``ValueError``) what ``rules.check_tp`` refuses."""
    model = Model(cfg, device=mesh.device, mesh=mesh)
    if not mesh.shared:
        _draw(model, cfg, mesh, seed)
        return model
    for turn in range(mesh.size):
        if turn == mesh.rank:
            _draw(model, cfg, mesh, seed)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
                torch.cuda.empty_cache()
        mesh.barrier()
    return model
