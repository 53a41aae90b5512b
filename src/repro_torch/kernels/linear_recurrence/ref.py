"""Plain PyTorch versions of the linear-recurrence kernel, the counterparts
of ``repro/kernels/linear_recurrence/ref.py``.

``linear_recurrence`` computes h_t = a_t * h_{t-1} + b_t along axis 1 with
a Hillis–Steele doubling scan over the whole sequence: ceil(log2 S)
vectorised passes of the associative combine (a1, b1) o (a2, b2) =
(a1 * a2, a2 * b1 + b2), each combining step t with step t - 2^i.  The
initial state is folded into step 0 first, as the reference does.

``linear_recurrence_chunked`` is the same recurrence computed as the
split-S kernel does (for tests and ``chip_smoke.py``, which hold the
kernel to it at the chunks ``ops.scan_plan`` picks; not for the model).
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


def linear_recurrence_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                              chunk: int) -> torch.Tensor:
    """The S steps cut into chunks of ``chunk`` (the last one padded with
    identity steps, a = 1 and b = 0).  Each chunk but the last gives its
    aggregate from h = 0, A = prod a_t and B = its scan's last h (pass 1);
    h0 is carried across the aggregates, h_in(c) = A_{c-1} * h_in(c-1) +
    B_{c-1}; each chunk is scanned again from its h_in (pass 2).  fp32."""
    a, b = a.float(), b.float()
    Bn, S, W = a.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    a = F.pad(a, (0, 0, 0, pad), value=1.0).reshape(Bn, n, chunk, W)
    b = F.pad(b, (0, 0, 0, pad), value=0.0).reshape(Bn, n, chunk, W)
    zero = torch.zeros(Bn * n, W, dtype=torch.float32, device=a.device)
    agg_b = linear_recurrence(a.reshape(-1, chunk, W), b.reshape(-1, chunk, W),
                              zero)[:, -1].reshape(Bn, n, W)
    agg_a = a.prod(dim=2)
    h_in = [h0.float()]
    for c in range(n - 1):
        h_in.append(agg_a[:, c] * h_in[-1] + agg_b[:, c])
    h = linear_recurrence(a.reshape(-1, chunk, W), b.reshape(-1, chunk, W),
                          torch.stack(h_in, dim=1).reshape(-1, W))
    return h.reshape(Bn, n * chunk, W)[:, :S]
