"""Cost of one call counted from shapes on the ``meta`` device: the
counterpart of ``repro/core/hlo.py``.

The reference compiles a step and reads XLA's ``cost_analysis()`` and the
HLO text.  There is no HLO here, hence the other name: ``summarize_call``
runs the call eagerly on meta tensors under
``torch.utils.flop_counter.FlopCounterMode``, which counts the operations
of every matrix product (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the
convolutions and attention ops in its registry) and nothing elementwise.
Meta tensors carry no values, so nothing is computed and nothing is
allocated.  The count is the whole program's: eager PyTorch runs every
loop, so there is no ``while`` body visited once to correct for.

Counting needs the plain versions: a CUDA kernel launched through ctypes
is invisible to the counter, so ``summarize_call`` refuses any tensor off
``meta``.

``CostSummary.ops`` (operations per ATen op) stands in for the
reference's ``op_histogram``.  ``collective_stats`` has no counterpart:
collectives exist only under a mesh, and the port's dry-run has none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor in ``obj``: a tensor, a module's parameters and
    buffers, and the leaves of dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def tree_bytes(*objs: Any) -> int:
    """Bytes of the distinct tensors in ``objs``."""
    seen, total = set(), 0
    for obj in objs:
        for t in _tensors(obj):
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
    return total


@dataclasses.dataclass
class CostSummary:
    flops: float            # matrix-product operations, the whole call
    argument_bytes: int     # bytes of the call's distinct argument tensors
    ops: Dict[str, int]     # operations per ATen op


def summarize_call(fn: Callable, *args: Any) -> CostSummary:
    """Count ``fn(*args)`` on the ``meta`` device.  Every tensor in
    ``args`` (a model's parameters included) must be a meta tensor."""
    for t in (t for a in args for t in _tensors(a)):
        if t.device.type != "meta":
            raise ValueError(f"counting runs on meta tensors only, got one on {t.device}: "
                             "the counter cannot see a kernel launched on a device")
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    ops = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return CostSummary(flops=float(counter.get_total_flops()),
                       argument_bytes=tree_bytes(*args), ops=ops)
