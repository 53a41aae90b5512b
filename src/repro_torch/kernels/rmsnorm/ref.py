"""Plain PyTorch versions of the fused RMSNorm kernel (gemma-style 1+scale),
the counterpart of ``repro/kernels/rmsnorm/ref.py``.

``add_rmsnorm`` is the residual add in front of the norm, as the model
runs them: the sum is rounded to the activation dtype before the
statistics, as a separate add and norm compute them.
"""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def check_residual(x: torch.Tensor, r: torch.Tensor) -> None:
    """Raise unless ``r`` has x's shape, dtype and device: a bf16 + fp32 sum
    would silently promote and change the model."""
    if r.dtype != x.dtype:
        raise TypeError(f"r is {r.dtype}, x {x.dtype}")
    if r.shape != x.shape or r.device != x.device:
        raise ValueError(f"r {tuple(r.shape)} on {r.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, rmsnorm(s))`` with ``s = x + r`` in x's dtype."""
    check_residual(x, r)
    s = x + r
    return s, rmsnorm(s, scale, eps)
