"""Plain PyTorch version of the fused RMSNorm kernel (gemma-style 1+scale),
the counterpart of ``repro/kernels/rmsnorm/ref.py``."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
