"""Parameter containers and elementary layers, the counterpart of
``repro/models/layers.py``.

Parameters live in small ``nn.Module``s whose attribute names are the leaf
names of the reference's parameter tree (``scale``, ``table``), so the
bridge and the size report map one onto the other.  Every parameter is
created empty on the caller's device and filled by ``init_`` from an
explicit ``torch.Generator`` at the reference initializer's scales
(``Maker.normal``: fan-in scaling on the first dimension).

A decode step under the serve rules (``sharding.rules.use_serve_rules``)
runs on a ``ServeLayout``: the residual stream is the rank's slice of
``d``, so a norm is K1's split mode around an all-reduce of its
statistic (``add_norm``), a product into a branch contracts the slice and
all-reduces its fp32 partials (``project_in``), and the head's logits are
summed over the slices before the vocabulary gather (``unembed``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.sharding import collectives


def new_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def init_normal_(p: torch.Tensor, gen: torch.Generator,
                 scale: Optional[float] = None) -> None:
    """Fill ``p`` with N(0, 1) * scale drawn in fp32; the default scale is
    1 / sqrt(fan-in of the first dimension), as in the reference."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(1, p.shape[0]))
    p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                        dtype=torch.float32).mul_(scale))


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

class Norm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = new_param((d,), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.scale.zero_()


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """A weight-stationary decode step on one rank of a ``("data",
    "model")`` mesh (the reference's ``SERVE_RULES``): the batch whole on
    every rank, the residual stream the rank's ``index``-th of ``parts``
    slices of its ``width`` (``d_model``) along ``axis``, the axis the
    weights' ``embed`` dim splits over (the data axis, or the pod axis
    where only the pods divide it; None: the stream whole, as those
    weights are).  ``rows`` is the slice of the batch whose cache the rank
    holds, its attention's outputs gathered over ``data`` after (None:
    the cache holds every row)."""
    axis: Any
    index: int
    parts: int
    width: int
    data: Any
    rows: Optional[slice]

    @property
    def split(self) -> bool:
        """Whether the residual stream is a slice of the width."""
        return self.axis is not None

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a norm scale: one stored whole (as a
        prefill under FSDP reads it) narrowed, one stored as the slice
        (the serve rules' placement) as it is."""
        if not self.split or t.shape[-1] != self.width:
            return t
        n = self.width // self.parts
        return t.narrow(-1, self.index * n, n)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return dispatch.rmsnorm(x, scale, eps)


def apply_norm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rms_norm(x, p.scale, eps)


def add_norm(p: Norm, x: torch.Tensor, r: Optional[torch.Tensor],
             eps: float = 1e-6, serve: Optional[ServeLayout] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add ``x + r`` and the norm of the sum, one kernel:
    returns ``(x + r, norm(x + r))``, or ``(x, norm(x))`` when ``r`` is
    None.  The reference's ``x = x + r; apply_norm(p, x)``, bit for bit.
    On a ``serve`` layout's slice of the width, the add is the slice's and
    the norm K1's split mode: the slice's fp32 sums of squares, their
    all-reduce over the slices, then the slice normalised over the whole
    width with its part of the scale."""
    if serve is not None and serve.split:
        if r is not None:
            x = x + r
        stat = collectives.reduce(dispatch.rmsnorm_sumsq(x), serve.axis)
        return x, dispatch.rmsnorm(x, serve.local(p.scale), eps, stat=stat, width=serve.width)
    if r is None:
        return x, apply_norm(p, x, eps)
    return dispatch.add_rmsnorm(x, r, p.scale, eps)


def project_in(x: torch.Tensor, ws: Sequence[torch.Tensor],
               serve: Optional[ServeLayout] = None) -> List[torch.Tensor]:
    """``x @ w`` (x (..., k), each w (k, n)) for each of ``ws``, in x's
    dtype.  On a ``serve`` layout's slice of the width each is the rank's
    fp32 partial product over its rows of ``w``, the partials of ``ws``
    all-reduced over the slices in one call and each sum rounded once."""
    if serve is None or not serve.split:
        return [torch.matmul(x, w) for w in ws]
    parts = torch.cat([matmul_fp32(x, w) for w in ws], dim=-1)
    summed = collectives.reduce(parts, serve.axis)
    return [t.to(x.dtype) for t in summed.split([w.shape[-1] for w in ws], dim=-1)]


# --------------------------------------------------------------------------
# rotary embeddings (split-half layout, fp32 angles)
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each (..., S, 1, head_dim) fp32, for positions (..., S).

    Computed once per forward pass and shared by every layer's q and k.  The
    halves are laid out so that ``apply_rope`` is ``x * cos + swap(x) * sin``,
    which equals the reference's ``[x1 cos - x2 sin, x2 cos + x1 sin]`` bit
    for bit (negation and ``a + (-b)`` are exact)."""
    angles = positions[..., None].float() * rope_freqs(head_dim, theta, positions.device)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[..., None, :],
            torch.cat([-sin, sin], dim=-1)[..., None, :])


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotary embedding of x (..., S, H, D), split-half layout, in fp32."""
    cos, sin = tables
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------

def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
        "relu": F.relu,
        "relu2": _relu2,  # Primer / Nemotron
    }[name]


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------

class Embedding(nn.Module):
    """A (vocab, d) table.  Under tensor parallelism (``tp``, a
    ``launch.mesh.TPMesh``) it holds the rows ``vocab_start ..
    vocab_start + vocab - 1`` of the full table."""

    def __init__(self, vocab: int, d: int, dtype, device, tp=None, vocab_start: int = 0):
        super().__init__()
        self.table = new_param((vocab, d), dtype, device)
        self.tp, self.vocab_start = tp, vocab_start

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.table, gen, scale=1.0)


def embed_tokens(p: Embedding, tokens: torch.Tensor, scale: bool,
                 d_model: int) -> torch.Tensor:
    """The table's rows for ``tokens``.  A vocabulary-sharded table looks
    up the tokens in its own rows, zeros the others, and sums over the
    ranks: each row is one rank's and zeros, so the sum is exact.  A
    table whose width is a data slice (a decode step under the serve
    rules) gives that slice of each row; the scale is still √d_model."""
    if p.tp is None:
        x = F.embedding(tokens, p.table)
    else:
        local = tokens - p.vocab_start
        mine = (local >= 0) & (local < p.table.shape[0])
        x = F.embedding(torch.where(mine, local, 0), p.table)
        x = collectives.reduce(x.masked_fill(~mine[..., None], 0), p.tp)
    if scale:  # the factor is rounded to the activation dtype first, on the
        # host: a host-to-device copy could not be captured in a CUDA graph
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype).item()
    return x


def _matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # meta takes the card's product too: the dry-run counts what the card
    # allocates, and an fp32 copy of ``w`` is not part of it
    if (x.is_cuda or x.is_meta) and x.dtype != torch.float32:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    return torch.matmul(x.float(), w.float())


class _MatmulFP32(torch.autograd.Function):
    """``_matmul_fp32`` with its gradients (``torch.mm(out_dtype=)`` has no
    derivative): dX = g @ w^T rounded to x's dtype, dW = x^T @ g rounded
    to w's, as the reference's VJP of its ``preferred_element_type=float32``
    einsum.  The fp32 cotangent is not rounded: both products take fp32
    copies of their inputs and run in fp32 (no TF32), the one rounding being
    the result's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _matmul_fp32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g2, w.float().t()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x.reshape(-1, x.shape[-1]).float().t(), g2).to(w.dtype)
        return dx, dw


def matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (x (..., k), w (k, n)) summed and returned in fp32, never
    rounded to bf16 on the way; differentiable in grad mode."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MatmulFP32.apply(x, w)
    return _matmul_fp32(x, w)


def unembed(p: Embedding, x: torch.Tensor, softcap: float = 0.0,
            serve: Optional[ServeLayout] = None) -> torch.Tensor:
    """fp32 logits (..., vocab).  As with the reference's
    ``preferred_element_type=float32``, bf16 products are summed and
    returned in fp32, never rounded to bf16 on the way.  A
    vocabulary-sharded table gives its own columns, gathered from every
    rank into the full row the sampler reads (the same bytes on every
    rank); the softcap, elementwise, follows.  On a ``serve`` layout's
    slice of the width the products over the slice are all-reduced over
    the slices first."""
    logits = matmul_fp32(collectives.copy(x, p.tp), p.table.t())
    if serve is not None and serve.split:
        logits = collectives.reduce(logits, serve.axis)
    if p.tp is not None:
        logits = collectives.gather(logits, -1, p.tp)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
