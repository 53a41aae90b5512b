"""The RG-LRU recurrent block of Griffin (RecurrentGemma), the counterpart of
the RG-LRU part of ``repro/models/recurrent.py``.  mLSTM and sLSTM (xlstm)
are not ported yet.

The block: a GeLU gate branch ``x @ in_g`` and a recurrent branch
``x @ in_x`` -> depthwise causal conv (width K) -> per-timestep decay
``a = exp(-8 softplus(lambda) r)`` and normalised input
``b = sqrt(1 - a^2) (i * xc)`` from block-diagonal gates -> the linear
recurrence ``h_t = a_t h_{t-1} + b_t`` in fp32 (``dispatch.linear_recurrence``,
the K5 kernel on the GPU) -> ``(h * gate) @ out``.

The arithmetic keeps the reference's order step for step (the conv's
shifted adds, ``softplus`` as ``logaddexp(x, 0)``, the clip inside the
square root, ``h`` cast to the activation dtype before the gate multiply),
so fp32 runs on the CPU agree with the reference to rounding.

The state a layer carries is its cache entry ``{"h": (B, W) fp32,
"conv": (B, K-1, W)}`` (``cache.init_rglru_state``).  The functions here
return the new state as fresh tensors; ``models.model`` writes it into the
entry in place.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn, init_normal_, new_param


def lambda_init(width: int) -> np.ndarray:
    """The reference's fixed Λ: ``a = exp(-8 softplus(Λ))`` lands in
    [0.9, 0.999] (Griffin), drawn from ``RandomState(0)``, not from the
    model's seed."""
    u = np.random.RandomState(0).uniform(0.9 ** 2, 0.999 ** 2, size=(width,))
    return np.log(np.expm1(-np.log(u) / (2 * 8.0))).astype(np.float32)  # inverse softplus


class RGLRU(nn.Module):
    """RG-LRU parameters, named like the reference's ``make_rglru_block``
    leaves; ``lambda`` is a Python keyword, so it is registered by name
    and read with ``getattr(p, "lambda")``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, W, H = cfg.d_model, cfg.resolved_lru_width, cfg.resolved_rec_heads
        Dh = W // H
        self.in_x = new_param((d, W), dtype, device)
        self.in_g = new_param((d, W), dtype, device)
        self.conv_w = new_param((cfg.rglru_conv_width, W), dtype, device)
        self.gate_a = new_param((H, Dh, Dh), dtype, device)
        self.gate_x = new_param((H, Dh, Dh), dtype, device)
        self.register_parameter("lambda", new_param((W,), dtype, device))
        self.out = new_param((W, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.in_x, gen)
        init_normal_(self.in_g, gen)
        init_normal_(self.conv_w, gen, scale=0.1)
        dh = self.gate_a.shape[1]
        init_normal_(self.gate_a, gen, scale=1.0 / math.sqrt(dh))
        init_normal_(self.gate_x, gen, scale=1.0 / math.sqrt(dh))
        lam = getattr(self, "lambda")
        lam.copy_(torch.from_numpy(lambda_init(lam.shape[0])))
        init_normal_(self.out, gen, scale=1.0 / math.sqrt(self.out.shape[0]))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 history: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width K by shifted adds: x (B, S, W), w
    (K, W), ``history`` (B, K-1, W) the previous inputs.  Returns (y,
    new_history), the new history being the last K-1 inputs."""
    K = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([history.to(x.dtype), x], dim=1)  # (B, S+K-1, W)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xp[:, i:i + S] * w[K - 1 - i]
    return y, (xp[:, S:] if K > 1 else history)


def _block_diag_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., H*Dh) @ block-diagonal w (H, Dh, Do) -> (..., H*Do)."""
    H, Dh, Do = w.shape
    xh = x.reshape(*x.shape[:-1], H, Dh)
    y = torch.einsum("...hd,hdo->...ho", xh, w)
    return y.reshape(*x.shape[:-1], H * Do)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_gates(p: RGLRU, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep decay a and gated, normalised input b (both fp32) from
    the conv'd branch xc."""
    r = torch.sigmoid(_block_diag_linear(xc, p.gate_a).float())
    i = torch.sigmoid(_block_diag_linear(xc, p.gate_x).float())
    log_a = -8.0 * _softplus(getattr(p, "lambda").float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization (Griffin eq. 4)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    b = beta * (i * xc.float())
    return a, b


def apply_rglru_seq(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                    state: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) from ``state`` (a cache entry).  Returns (y (B, S, d),
    new_state): the state after the last step, as fresh tensors."""
    g = act_fn("gelu")(torch.matmul(x, p.in_g))
    xr = torch.matmul(x, p.in_x)
    xc, conv_hist = _causal_conv(xr, p.conv_w, state["conv"])
    a, b = _rglru_gates(p, xc)
    h = dispatch.linear_recurrence(a, b, state["h"])  # (B, S, W) fp32
    y = torch.matmul(h.to(x.dtype) * g, p.out)
    return y, {"h": h[:, -1], "conv": conv_hist}


def apply_rglru_step(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                     state: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, d): one decode step against the carried state."""
    return apply_rglru_seq(p, x, cfg, state)
