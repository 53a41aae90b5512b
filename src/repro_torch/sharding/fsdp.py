"""FSDP over the data axis of a ``("data", "model")`` mesh, the counterpart
of the reference's ``embed`` -> ``("pod", "data")`` parameter sharding,
which GSPMD gathers for use and reduce-scatters in the backward.

A rank stores its data shard of each leaf that has a data dim
(``rules.data_split``: the reference's ``embed``, where dp divides it, or
on a mesh of pods where the pods do) and the whole of every other leaf.
``FSDP.gathered(module)`` is the context ``Model.forward_train``,
``prefill`` and ``decode_step`` run each module in (every block, the
embedding, the head): it puts each data-sharded parameter's gathered
whole (``collectives.fsdp_gather``) in the module's place for the
module's forward and puts the shard back after, so only the autograd
graph (or, under remat, nothing) holds the gathered weights; a remat
recompute gathers again, every rank in the same order.  In the backward
each gathered parameter's gradient is reduce-scattered back to the shard
(a pod-split leaf's is all-reduced over the data axis and its part
taken).

``set_rows(summed)`` says whether the batch now running is split over the
data ranks (their gradients then sum: reduce-scatter, and an all-reduce
of the replicated leaves' gradients, ``sync_replicated``) or whole on
every data rank (a batch data does not divide: each rank's gradient is
already the whole one, and the shard takes its slice).  It also points
each MoE layer at the data axis, so it routes the global batch
(``models/moe.py``), in training and in a sharded prefill or decode step
alike.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.moe import MoE
from repro_torch.sharding import collectives


class FSDP:
    """The data-axis shards of ``model``'s parameters: ``dims`` maps each
    parameter's name to its (data dim, the axis it splits over: the data
    axis, or the pod axis of a leaf only the pods divide), None where it
    is whole on every data rank."""

    def __init__(self, model: nn.Module, data, dims: Dict[str, Optional[Tuple[int, object]]]):
        self.data = data   # the data axis (``launch.mesh.TPMesh``)
        self.dims = dict(dims)
        self.summed = data.size > 1
        params = dict(model.named_parameters())
        # the shard of each data-sharded leaf, by identity: its dim and axis
        self._dim = {id(params[name]): split for name, split in self.dims.items()
                     if split is not None}
        self._moes = [m for m in model.modules() if isinstance(m, MoE)]

    def set_rows(self, summed: bool) -> None:
        """The next batch's rows are split over the data ranks (``summed``)
        or whole on each."""
        self.summed = summed and self.data.size > 1
        for moe in self._moes:
            moe.dp = self.data if self.summed else None

    @contextlib.contextmanager
    def gathered(self, module: nn.Module) -> Iterator[None]:
        """``module``'s data-sharded parameters gathered whole while the
        block runs, the shards put back after."""
        swaps = []
        for sub in module.modules():
            for leaf, p in list(sub._parameters.items()):
                split = self._dim.get(id(p))
                if split is not None:
                    dim, axis = split
                    swaps.append((sub, leaf, p))
                    sub._parameters[leaf] = collectives.fsdp_gather(
                        p, dim, axis, self.summed, over=None if axis is self.data else self.data)
        try:
            yield
        finally:
            for sub, leaf, p in swaps:
                sub._parameters[leaf] = p

    @torch.no_grad()
    def sync_replicated(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum the replicated leaves' gradients over the data ranks, in
        place, one all-reduce per dtype (nothing where the rows were not
        split)."""
        if not self.summed:
            return
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for name in (n for n, dim in self.dims.items() if dim is None):
            by_dtype.setdefault(grads[name].dtype, []).append(name)
        for names in by_dtype.values():
            flat = self.data.all_reduce(torch.cat([grads[n].reshape(-1) for n in names]))
            for name, part in zip(names, flat.split([grads[n].numel() for n in names])):
                grads[name].copy_(part.view_as(grads[name]))
