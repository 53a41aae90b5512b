"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``), plain and with
the residual add fused in front.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  The wrapper launches on the current stream and
never synchronises, so a CUDA graph can capture it.  ``rmsnorm`` and
``add_rmsnorm`` both count on ``rmsnorm.launches``: one launch per norm.

Both are differentiable: with grad on and an input that requires grad,
the kernel runs inside a ``torch.autograd.Function`` whose backward is
the VJP of the plain version (``_vjp.plain_vjp``), as the reference's
``custom_vjp`` (``repro/kernels/rmsnorm/ops.py``).  ``add_rmsnorm``'s two
outputs both carry gradient; its backward sums their cotangents.

A norm over a width that tensor-parallel ranks split is two launches
around the ranks' all-reduce: ``rmsnorm_sumsq`` (each row's fp32 sum of
squares of the rank's slice) and ``rmsnorm(..., stat=, width=)`` (the
slice normalised by the reduced sums); each counts one launch.  Both are
differentiable the same way (the mLSTM cell norm under tensor-parallel
training): the statistic's gradient flows back through the all-reduce.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _vjp
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


def _rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    _check(x, scale)
    y = torch.empty_like(x)
    _launch(x, None, scale, None, y, eps)
    return y


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _stat_kernel(x, scale, eps: float, stat: torch.Tensor, width: int) -> torch.Tensor:
    _check(x, scale)
    d = x.shape[-1]
    if (stat.dtype != torch.float32 or stat.device != x.device or not stat.is_contiguous()
            or stat.numel() != x.numel() // d or width < d):
        raise ValueError(f"stat {stat.dtype} {tuple(stat.shape)} on {stat.device} is not "
                         f"x's {x.numel() // d} rows in fp32 over a width >= {d}")
    y = torch.empty_like(x)
    status = _build.load()[_LAUNCHERS[x.dtype].replace("rmsnorm", "rmsnorm_stat")](
        x.data_ptr(), stat.data_ptr(), scale.data_ptr(), y.data_ptr(), x.numel() // d, d,
        width, int(scale.dtype == torch.float32), eps, _build.stream(x))
    if status != 0:
        raise RuntimeError(f"rmsnorm_stat launch failed: CUDA error {status}")
    rmsnorm.launches += 1
    return y


def _sumsq_kernel(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _LAUNCHERS or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"x {x.dtype} {tuple(x.shape)}: want contiguous bf16 or fp32 rows")
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    status = _build.load()[_LAUNCHERS[x.dtype].replace("rmsnorm", "rmsnorm_sumsq")](
        x.data_ptr(), out.data_ptr(), x.numel() // x.shape[-1], x.shape[-1], _build.stream(x))
    if status != 0:
        raise RuntimeError(f"rmsnorm_sumsq launch failed: CUDA error {status}")
    rmsnorm.launches += 1
    return out


class _SumSq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sumsq_kernel(x)

    @staticmethod
    def backward(ctx, g):
        return _vjp.plain_vjp(ref.sumsq, ctx.saved_tensors, (g,), (True,))


class _RMSNormStat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, stat, eps, width):
        ctx.save_for_backward(x, scale, stat)
        ctx.eps, ctx.width = eps, width
        return _stat_kernel(x, scale, eps, stat, width)

    @staticmethod
    def backward(ctx, g):
        eps, width = ctx.eps, ctx.width
        grads = _vjp.plain_vjp(lambda x, s, st: ref.rmsnorm(x, s, eps, st, width),
                               ctx.saved_tensors, (g,), ctx.needs_input_grad[:3])
        return (*grads, None, None)


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Each row's fp32 sum of squares over the last dim, (x.shape[:-1]):
    the split norm's statistic, one launch."""
    if not x.is_cuda:
        return ref.sumsq(x)
    if _needs_grad(x):
        return _SumSq.apply(x)
    return _sumsq_kernel(x)


def _add_rmsnorm_kernel(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                        eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    ref.check_residual(x, r)
    if not r.is_contiguous():
        raise ValueError("r must be contiguous")
    _check(x, scale)
    s, y = torch.empty_like(x), torch.empty_like(x)
    _launch(x, r, scale, s, y, eps)
    return s, y


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_kernel(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        grads = _vjp.plain_vjp(lambda x, s: ref.rmsnorm(x, s, eps), ctx.saved_tensors, (g,),
                               ctx.needs_input_grad[:2])
        return (*grads, None)


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, scale, eps):
        ctx.save_for_backward(x, r, scale)
        ctx.eps = eps
        return _add_rmsnorm_kernel(x, r, scale, eps)

    @staticmethod
    def backward(ctx, g_s, g_y):
        eps = ctx.eps
        grads = _vjp.plain_vjp(lambda x, r, s: ref.add_rmsnorm(x, r, s, eps),
                               ctx.saved_tensors, (g_s, g_y), ctx.needs_input_grad[:3])
        return (*grads, None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            stat: Optional[torch.Tensor] = None, width: int = 0) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` over the last dim; with
    ``stat`` (x's rows, fp32) the mean of squares is ``stat / width``."""
    if not x.is_cuda:
        return ref.rmsnorm(x, scale, eps, stat, width)
    if stat is not None:
        if _needs_grad(x, scale, stat):
            return _RMSNormStat.apply(x, scale, stat, eps, width)
        return _stat_kernel(x, scale, eps, stat, width)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm_kernel(x, scale, eps)


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, rmsnorm(s))`` with ``s = x + r`` rounded to x's dtype, in one
    launch; x and r of one shape, dtype and device, both contiguous."""
    if not x.is_cuda:
        return ref.add_rmsnorm(x, r, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or r.requires_grad
                                    or scale.requires_grad):
        return _AddRMSNorm.apply(x, r, scale, eps)
    return _add_rmsnorm_kernel(x, r, scale, eps)


rmsnorm.launches = 0
