"""MLP blocks: gated (SwiGLU/GeGLU) and classic 2-matrix (ReLU²/ReLU) FFNs,
the counterpart of ``repro/models/mlp.py``."""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import act_fn, init_normal_, new_param


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, gated: bool, dtype, device):
        super().__init__()
        self.wg = new_param((d, d_ff), dtype, device)
        if gated:
            self.wu = new_param((d, d_ff), dtype, device)
        self.wd = new_param((d_ff, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.wg, gen)
        init_normal_(self.wd, gen, scale=1.0 / math.sqrt(self.wd.shape[0]))
        if hasattr(self, "wu"):
            init_normal_(self.wu, gen)


def apply_mlp(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = act_fn(act)(torch.matmul(x, p.wg))
    if hasattr(p, "wu"):
        h = h * torch.matmul(x, p.wu)
    return torch.matmul(h, p.wd)
