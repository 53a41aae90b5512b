"""Wrapper of the CUDA linear-recurrence kernel
(``csrc/linear_recurrence.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  The wrapper launches on the current stream and
never synchronises, so a CUDA graph can capture it.  With grad on and an
input that requires grad it runs inside a ``torch.autograd.Function``
whose backward is the VJP of the plain doubling scan (``ref.py``),
recomputed from the saved inputs, as the reference's ``custom_vjp``
(``repro/kernels/linear_recurrence/ops.py``).

The kernel cuts the sequence into chunks across blocks (split-S): pass 1
writes each chunk's aggregate, pass 2 carries h across them and rescans
each chunk.  One call is two kernel launches when there is more than one
chunk, and counts as one launch of the wrapper.  ``scan_plan`` picks the
chunks from the shapes alone.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, _vjp
from repro_torch.kernels.linear_recurrence import ref

CHANNELS = 128      # channels (w) per block
BLOCKS_PER_SM = 3   # blocks per SM the split aims for
MIN_CHUNK = 32      # fewest steps a chunk of a split scan holds


def scan_plan(B: int, S: int, W: int, sms: int) -> tuple[int, int]:
    """``(n_chunks, chunk)``: the S steps cut into n_chunks chunks of
    ``chunk`` steps (the last one ragged, none empty) so that the blocks
    of B * ceil(W / CHANNELS) * n_chunks come to about ``BLOCKS_PER_SM``
    per SM, each chunk at least ``MIN_CHUNK`` steps.  One chunk (a single
    pass from h0) at S < 2 * MIN_CHUNK, as in decode, or when the channels
    alone fill the card.  Shapes only, so a captured call stays right."""
    want = -(-BLOCKS_PER_SM * sms // (B * -(-W // CHANNELS)))
    n = max(1, min(want, S // MIN_CHUNK))
    chunk = -(-S // n)
    return -(-S // chunk), chunk


def check_plan(S: int, n_chunks: int, chunk: int) -> None:
    """Raise ``ValueError`` unless n_chunks chunks of ``chunk`` steps cover
    the S steps with none empty: what the C entry point checks again."""
    if S < 1 or n_chunks < 1 or chunk < 1 or chunk * (n_chunks - 1) >= S or chunk * n_chunks < S:
        raise ValueError(f"{n_chunks} chunks of {chunk} steps do not tile {S} steps")


def workspace_bytes(B: int, S: int, W: int, sms: int) -> int:
    """The fp32 chunk aggregates (A, B) a split scan allocates for pass 1;
    0 for one chunk."""
    n_chunks, _ = scan_plan(B, S, W, sms)
    return 0 if n_chunks == 1 else 4 * 2 * B * n_chunks * W


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _linear_recurrence_kernel(a: torch.Tensor, b: torch.Tensor,
                              h0: torch.Tensor) -> torch.Tensor:
    _check(a, b, h0)
    B, S, W = a.shape
    n_chunks, chunk = scan_plan(B, S, W, _sm_count(a.device.index or 0))
    check_plan(S, n_chunks, chunk)
    out = torch.empty_like(a)
    agg, scratch = None, [0, 0]  # pass 1's chunk aggregates (A, B), fp32
    if n_chunks > 1:
        agg = torch.empty(2, B * n_chunks * W, device=a.device, dtype=torch.float32)
        scratch = [agg[0].data_ptr(), agg[1].data_ptr()]
    status = _build.load()["linear_recurrence_f32"](
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), *scratch,
        B, S, W, chunk, n_chunks, _build.stream(a))
    if status != 0:
        raise RuntimeError(f"linear_recurrence launch failed: CUDA error {status}")
    linear_recurrence.launches += 1
    return out


class _LinearRecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.save_for_backward(a, b, h0)
        return _linear_recurrence_kernel(a, b, h0)

    @staticmethod
    def backward(ctx, g):
        return _vjp.plain_vjp(ref.linear_recurrence, ctx.saved_tensors, (g,),
                              ctx.needs_input_grad)


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from ``h0``.  a, b: (B, S, W)
    float32; h0: (B, W) float32.  Returns h: (B, S, W) float32."""
    if not a.is_cuda:
        return ref.linear_recurrence(a, b, h0)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or h0.requires_grad):
        return _LinearRecurrence.apply(a, b, h0)
    return _linear_recurrence_kernel(a, b, h0)


linear_recurrence.launches = 0
