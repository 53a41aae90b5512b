"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), plain and with
the residual add fused in front.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  The wrapper launches on the current stream and
never synchronises, so a CUDA graph can capture it.  ``rmsnorm`` and
``add_rmsnorm`` both count on ``rmsnorm.launches``: one launch per norm.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import ref

MAX_D = 16384
_LAUNCHERS = {torch.bfloat16: "rmsnorm_bf16", torch.float32: "rmsnorm_f32"}


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    d = x.shape[-1] if x.dim() else 0
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("x and scale must be contiguous")
    if x.dtype not in _LAUNCHERS or scale.dtype not in _LAUNCHERS:
        raise TypeError(f"x {x.dtype} / scale {scale.dtype} not in {tuple(_LAUNCHERS)}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match d={d}")
    if not 0 < d <= MAX_D or x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)}: want d in 1..{MAX_D} and at least one row")


def _launch(x, r, scale, s, y, eps: float) -> None:
    d = x.shape[-1]
    status = _build.load()[_LAUNCHERS[x.dtype]](
        x.data_ptr(), None if r is None else r.data_ptr(), scale.data_ptr(),
        None if s is None else s.data_ptr(), y.data_ptr(), x.numel() // d, d,
        int(scale.dtype == torch.float32), eps, _build.stream(x))
    if status != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {status}")
    rmsnorm.launches += 1


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim."""
    if not x.is_cuda:
        return ref.rmsnorm(x, scale, eps)
    _check(x, scale)
    y = torch.empty_like(x)
    _launch(x, None, scale, None, y, eps)
    return y


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, rmsnorm(s))`` with ``s = x + r`` rounded to x's dtype, in one
    launch; x and r of one shape, dtype and device, both contiguous."""
    if not x.is_cuda:
        return ref.add_rmsnorm(x, r, scale, eps)
    ref.check_residual(x, r)
    if not r.is_contiguous():
        raise ValueError("r must be contiguous")
    _check(x, scale)
    s, y = torch.empty_like(x), torch.empty_like(x)
    _launch(x, r, scale, s, y, eps)
    return s, y


rmsnorm.launches = 0
