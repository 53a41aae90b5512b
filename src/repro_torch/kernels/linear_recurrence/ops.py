"""Wrapper of the CUDA linear-recurrence kernel
(``csrc/linear_recurrence.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  The wrapper launches on the current stream and
never synchronises, so a CUDA graph can capture it.  Inference only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.linear_recurrence import ref


def _check(a, b, h0):
    for name, t in {"a": a, "b": b, "h0": h0}.items():
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"want a, b (B,S,W) of one shape; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    B, S, W = a.shape
    if tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B, W) = {(B, W)}")
    if B == 0 or S == 0 or W == 0:
        raise ValueError(f"empty recurrence {tuple(a.shape)}")


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from ``h0``.  a, b: (B, S, W)
    float32; h0: (B, W) float32.  Returns h: (B, S, W) float32."""
    if not a.is_cuda:
        return ref.linear_recurrence(a, b, h0)
    _check(a, b, h0)
    B, S, W = a.shape
    out = torch.empty_like(a)
    status = _build.load()["linear_recurrence_f32"](
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"linear_recurrence launch failed: CUDA error {status}")
    linear_recurrence.launches += 1
    return out


linear_recurrence.launches = 0
