"""Wrapper of the Triton RMSNorm kernel (``rmsnorm.py``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import ref
from repro_torch.kernels.rmsnorm import rmsnorm as triton_rmsnorm

_DTYPES = (torch.bfloat16, torch.float32)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if not x.is_cuda:
        return ref.rmsnorm(x, scale, eps)
    d = x.shape[-1]
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("x and scale must be contiguous")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"x {x.dtype} / scale {scale.dtype} not in {_DTYPES}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match d={d}")
    if not 0 < d <= triton_rmsnorm.MAX_D:
        raise ValueError(f"d={d} outside 1..{triton_rmsnorm.MAX_D}")
    out = triton_rmsnorm.rmsnorm(x, scale, eps)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
