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
reference's ``op_histogram``.  ``collective_stats`` is
``sharding/record.py``: a rank's program runs on meta against a
``RecordingMesh``, which counts each collective it issues.

Peak live bytes (``summarize_call(..., track=True)``, the counterpart of
``memory_analysis``'s temp size): ``LiveBytes`` adds each new storage's
bytes when an operation makes it and takes them off when the storage is
freed (a finalizer on each), and keeps the peak; a view or an alias of a
storage it has seen, or of an operation's input, counts nothing more, and
the call's arguments are not counted.  The rule for the kernels: on meta
the five kernel entries (``kernels/dispatch.py``, K1-K5) run their plain
versions, which allocate what the card's kernels never do (K2's plain
forward builds fp32 (B, Hq, S, T) scores; ``flash_attention.cu`` keeps
them in registers).  So under the tracker a kernel entry is counted as
the card allocates for it (``as_kernel``): its outputs, and the fp32
workspace of a split launch (K3, K4, K5 at the H100's 132 SMs) while it
runs, nothing of its plain version's insides; with grad on it saves its
inputs for the backward, and its backward is the plain version's VJP
recomputed (``kernels/_vjp.py``), counted in full, since the card runs
that plain VJP too.  The FLOPs of such a call count the plain forward's
products, and in the backward the recompute's as well.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import _vjp

# the card's streaming multiprocessors (H100 SXM5), which a split launch's
# plan reads (``kernels/decode_attention/ops.py:split_plan``)
CARD_SMS = 132


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


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _flat(obj) -> Iterator[torch.Tensor]:
    """The tensors of an operation's arguments or outputs (tensors, and
    lists, tuples and dicts of them)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _flat(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _flat(v)


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages operations make, live and at their peak,
    beyond those of ``known`` (the call's arguments)."""

    def __init__(self, known: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.live = self.peak = 0
        self._keys = set()                    # the live storages counted
        self._known = {_key(t) for t in known}
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._paused:
            inputs = {_key(t) for t in _flat((args, kwargs))}
            for t in _flat(out):
                self._add(t, inputs)
        return out

    def _add(self, t: torch.Tensor, inputs) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in inputs or key in self._keys or key in self._known:
            return
        n = storage.nbytes()
        self._keys.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._keys.discard(key)
        self.live -= n

    def transient(self, nbytes: int) -> None:
        """``nbytes`` live for a moment on top of what is (a workspace)."""
        self.peak = max(self.peak, self.live + nbytes)

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1


_ACTIVE: Optional[LiveBytes] = None   # the tracker a counted call runs under


def tracking(x: torch.Tensor) -> bool:
    """Whether ``x`` is a meta tensor of a call the tracker counts (a kernel
    entry then goes through ``as_kernel``)."""
    return _ACTIVE is not None and x.device.type == "meta"


def _kernel_forward(fn: Callable, inputs, workspace: int):
    with torch.no_grad(), _ACTIVE.paused():
        out = fn(*inputs)
    # the kernel's own outputs, made outside the pause so they count
    out = pytree.tree_map(lambda t: torch.empty_like(t, memory_format=torch.contiguous_format),
                          out)
    _ACTIVE.transient(workspace)
    return out


class _AsKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, workspace, *inputs):
        ctx.fn = fn
        ctx.save_for_backward(*inputs)
        return _kernel_forward(fn, inputs, workspace)

    @staticmethod
    def backward(ctx, *cotangents):
        return (None, None) + _vjp.plain_vjp(ctx.fn, ctx.saved_tensors, cotangents,
                                             ctx.needs_input_grad[2:])


def as_kernel(fn: Callable, inputs: Sequence[torch.Tensor], workspace: int = 0):
    """``fn(*inputs)`` (a kernel's plain version) as the card's kernel
    allocates for it, under the tracker: its outputs and ``workspace``
    bytes while it runs; with grad on, an ``autograd.Function`` that saves
    ``inputs`` and differentiates ``fn`` by its plain VJP."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _AsKernel.apply(fn, workspace, *inputs)
    return _kernel_forward(fn, inputs, workspace)


@dataclasses.dataclass
class CostSummary:
    flops: float            # matrix-product operations, the whole call
    argument_bytes: int     # bytes of the call's distinct argument tensors
    ops: Dict[str, int]     # operations per ATen op
    output_bytes: Optional[int] = None   # bytes of the tensors the call returns
    temp_bytes: Optional[int] = None     # peak live bytes beyond the arguments


def summarize_call(fn: Callable, *args: Any, track: bool = False) -> CostSummary:
    """Count ``fn(*args)`` on the ``meta`` device.  Every tensor in
    ``args`` (a model's parameters included) must be a meta tensor.  With
    ``track`` the peak live bytes beyond the arguments (``LiveBytes``) and
    the bytes of what ``fn`` returns are counted too."""
    global _ACTIVE
    for t in (t for a in args for t in _tensors(a)):
        if t.device.type != "meta":
            raise ValueError(f"counting runs on meta tensors only, got one on {t.device}: "
                             "the counter cannot see a kernel launched on a device")
    counter = FlopCounterMode(display=False)
    tracker = LiveBytes([t for a in args for t in _tensors(a)]) if track else None
    with counter, (tracker if track else contextlib.nullcontext()):
        _ACTIVE = tracker
        try:
            out = fn(*args)
        finally:
            _ACTIVE = None
    ops = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return CostSummary(flops=float(counter.get_total_flops()),
                       argument_bytes=tree_bytes(*args), ops=ops,
                       output_bytes=tree_bytes(out) if track else None,
                       temp_bytes=tracker.peak if track else None)
