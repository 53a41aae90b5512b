"""MLP blocks: gated (SwiGLU/GeGLU) and classic 2-matrix (ReLU²/ReLU) FFNs,
the counterpart of ``repro/models/mlp.py``.

A tensor-parallel shard of ``shards`` ranks holds 1 / shards of the
hidden where that divides it (column-parallel ``wg``/``wu``, row-parallel
``wd``: its output a partial sum), else the whole MLP (its output whole).
Under grad a split MLP's input is ``collectives.copy``'d: its gradient is
summed over the ranks.  On a decode step under the serve rules the input
is the rank's slice of ``d`` and so are ``wg``/``wu``'s rows and ``wd``'s
columns: the gate and up products are summed over the slices
(``layers.project_in``), and the output is the rank's slice of ``d``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models.layers import (
    ServeLayout, act_fn, init_normal_, matmul_fp32, new_param, project_in,
)
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import divides, local_size


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, gated: bool, dtype, device, shards: int = 1):
        super().__init__()
        # a shard's output is one rank's partial sum, kept in fp32 for the
        # sum over the ranks, where its hidden is split
        self.partial = divides(shards, d_ff)
        self.tp = None  # a split MLP's mesh (set by ``Model``)
        d_ff = local_size(d_ff, shards)
        self.wg = new_param((d, d_ff), dtype, device)
        if gated:
            self.wu = new_param((d, d_ff), dtype, device)
        self.wd = new_param((d_ff, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.wg, gen)
        init_normal_(self.wd, gen, scale=1.0 / math.sqrt(self.wd.shape[0]))
        if hasattr(self, "wu"):
            init_normal_(self.wu, gen)


def apply_mlp(p: MLP, x: torch.Tensor, act: str = "silu",
              serve: Optional[ServeLayout] = None) -> torch.Tensor:
    """The FFN; a shard's partial sum in fp32."""
    if p.partial:
        x = collectives.copy(x, p.tp)
    g, *u = project_in(x, [p.wg] + ([p.wu] if hasattr(p, "wu") else []), serve)
    h = act_fn(act)(g)
    if u:
        h = h * u[0]
    return (matmul_fp32 if p.partial else torch.matmul)(h, p.wd)
