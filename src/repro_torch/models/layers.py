"""Parameter containers and elementary layers, the counterpart of
``repro/models/layers.py``.

Parameters live in small ``nn.Module``s whose attribute names are the leaf
names of the reference's parameter tree (``scale``, ``table``), so the
bridge and the size report map one onto the other.  Every parameter is
created empty on the caller's device and filled by ``init_`` from an
explicit ``torch.Generator`` at the reference initializer's scales
(``Maker.normal``: fan-in scaling on the first dimension).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import dispatch


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
                        dtype=torch.float32) * scale)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

class Norm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = new_param((d,), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        self.scale.zero_()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return dispatch.rmsnorm(x, scale, eps)


def apply_norm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rms_norm(x, p.scale, eps)


def add_norm(p: Norm, x: torch.Tensor, r: Optional[torch.Tensor],
             eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add ``x + r`` and the norm of the sum, one kernel:
    returns ``(x + r, norm(x + r))``, or ``(x, norm(x))`` when ``r`` is
    None.  The reference's ``x = x + r; apply_norm(p, x)``, bit for bit."""
    if r is None:
        return x, apply_norm(p, x, eps)
    return dispatch.add_rmsnorm(x, r, p.scale, eps)


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
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.table = new_param((vocab, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.table, gen, scale=1.0)


def embed_tokens(p: Embedding, tokens: torch.Tensor, scale: bool,
                 d_model: int) -> torch.Tensor:
    x = F.embedding(tokens, p.table)
    if scale:  # the factor is rounded to the activation dtype first, on the
        # host: a host-to-device copy could not be captured in a CUDA graph
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype).item()
    return x


def unembed(p: Embedding, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """fp32 logits (..., vocab).  As with the reference's
    ``preferred_element_type=float32``, bf16 products are summed and
    returned in fp32, never rounded to bf16 on the way."""
    if x.is_cuda and x.dtype != torch.float32:
        logits = torch.mm(x.reshape(-1, x.shape[-1]), p.table.t(),
                          out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        logits = torch.matmul(x.float(), p.table.float().t())
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
