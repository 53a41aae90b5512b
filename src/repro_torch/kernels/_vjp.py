"""Gradients of the hand-written kernels, the counterpart of the
reference's ``jax.custom_vjp`` wrappers (``repro/kernels/*/ops.py``): the
forward is the kernel's, the backward the VJP of the kernel's plain version
(``ref.py``) recomputed from the saved inputs.  There is no backward
kernel: the reference has none to port.

A wrapper takes its ``torch.autograd.Function`` only when grad mode is on
and an input requires grad (tested inline: a fraction of a µs of host time
on every eager call); otherwise it makes the direct call, so the serving
and measure paths (and the CUDA graphs they capture) are untouched.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def plain_vjp(fn: Callable, inputs: Sequence[torch.Tensor], cotangents: Sequence[torch.Tensor],
              needs: Sequence[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradients of ``fn(*inputs)`` (one output or a tuple) against
    each input whose ``needs`` is true, given the outputs' ``cotangents``;
    None for the others.  ``fn`` runs again under grad mode on detached
    copies of the inputs; the cotangents of several outputs are summed
    into each input by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, c) for o, c in zip(outs, cotangents) if o.requires_grad]
    wrt = [t for t, n in zip(leaves, needs) if n]
    if not pairs or not wrt:
        return tuple(None for _ in needs)
    grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                                     allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)
