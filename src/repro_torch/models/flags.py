"""Thread-local flags read by the model code, the counterpart of
``repro/models/flags.py``.

``moe_blocked`` — route a MoE layer through ``moe.apply_moe_blocked``
(block-local dispatch) instead of ``moe.apply_moe``, as the reference's
flag does; the dry-run sets it for ``--opt moe_block``.

``fold_loops`` — for counting only, on the ``meta`` device: the sLSTM's
time loop runs its first step, then the cell once over the other S - 1
steps as one batch axis (``recurrent.apply_slstm_seq``).  Every product
keeps its shapes, so ``FlopCounterMode`` counts what the S steps would,
forward and backward, in one pass instead of S; the values are not the
loop's, so the cell refuses the flag off ``meta``.  The dry-run
(``launch/dryrun.py``) sets it; nothing else does.

The reference's ``unroll_scans`` has no counterpart: eager PyTorch runs
every loop already, where XLA's cost analysis visits a ``while`` body once.
"""

from __future__ import annotations

import contextlib
import threading


class _Flags(threading.local):
    def __init__(self):
        self.moe_blocked = False
        self.fold_loops = False


_FLAGS = _Flags()


def moe_blocked() -> bool:
    return _FLAGS.moe_blocked


@contextlib.contextmanager
def use_moe_blocked(value: bool = True):
    prev = _FLAGS.moe_blocked
    _FLAGS.moe_blocked = value
    try:
        yield
    finally:
        _FLAGS.moe_blocked = prev


def fold_loops() -> bool:
    return _FLAGS.fold_loops


@contextlib.contextmanager
def use_fold_loops(value: bool = True):
    prev = _FLAGS.fold_loops
    _FLAGS.fold_loops = value
    try:
        yield
    finally:
        _FLAGS.fold_loops = prev
