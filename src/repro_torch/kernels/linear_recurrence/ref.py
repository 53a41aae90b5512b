"""Plain PyTorch version of the linear-recurrence kernel, the counterpart of
``repro/kernels/linear_recurrence/ref.py``.

Computes h_t = a_t * h_{t-1} + b_t along axis 1 with a Hillis–Steele
doubling scan over the whole sequence: ceil(log2 S) vectorised passes of
the associative combine (a1, b1) o (a2, b2) = (a1 * a2, a2 * b1 + b2),
each combining step t with step t - 2^i.  The initial state is folded into
step 0 first, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W); h0: (B, W).  Returns h: (B, S, W) fp32."""
    a, b = a.float(), b.float()
    b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    shift = 1
    while shift < S:
        a_prev = F.pad(a[:, :-shift], (0, 0, shift, 0), value=1.0)
        b_prev = F.pad(b[:, :-shift], (0, 0, shift, 0), value=0.0)
        b = a * b_prev + b
        a = a * a_prev
        shift *= 2
    return b
