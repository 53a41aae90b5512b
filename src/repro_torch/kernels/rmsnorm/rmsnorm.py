"""Triton fused RMSNorm (gemma-style ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``).

Replaces the TPU kernel ``repro/kernels/rmsnorm/rmsnorm.py::rmsnorm``
(``_kernel``).  What bounds it on the H100: memory.  It reads each row once
and writes it once, ~4 FLOPs per element, far below the card's
operations-per-byte line.  Its design does the whole norm in one pass: one
program per row loads the row (masked to the next power of two, up to
16384), reduces the mean square in fp32 and stores the scaled row, so no
intermediate touches device memory.

``triton`` is imported when the kernel is first launched, never when this
module is imported: the CPU tests import every module of the port.
"""

import functools

import torch

MAX_D = 16384


@functools.cache
def _compile():
    global tl  # the jitted body resolves ``tl`` among this module's globals
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, d, eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=0) / d
        y = x * tl.rsqrt(ms + eps)
        s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(o_ptr + row * d + cols, (y * (1.0 + s)).to(o_ptr.dtype.element_ty),
                 mask=mask)

    return triton, rmsnorm_kernel


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch on a contiguous CUDA ``x`` (..., d) and ``scale`` (d,)."""
    triton, kernel = _compile()
    d = x.shape[-1]
    out = torch.empty_like(x)
    block = triton.next_power_of_2(d)
    num_warps = 4 if block <= 1024 else 8 if block <= 8192 else 16
    kernel[(x.numel() // d,)](x, scale, out, d, eps, BLOCK=block, num_warps=num_warps)
    return out
