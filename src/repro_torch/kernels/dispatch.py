"""Kernel dispatch: route the hot-spot ops to the Hopper kernels or to their
plain PyTorch versions, the counterpart of ``repro/kernels/dispatch.py``.

The device of the inputs decides: a CUDA tensor goes to the kernel (which
launches or raises), a CPU tensor to the plain version.  The one switch is
``use_backend("torch")``, which sends CUDA tensors to the plain versions
too, so a run can compare the two on the same inputs.

Under the dry-run's live-bytes tracker (``core/cost.py``) a meta tensor's
call is counted as the card's kernel allocates (``cost.as_kernel``): its
outputs and a split launch's workspace, its plain version run unseen.

Launch accounting: each wrapper counts one launch per call on its
``launches``.  On a tensor-parallel rank an mLSTM cell's norm over a width
tp splits is K1's two split launches (``rmsnorm_sumsq``, the ranks'
all-reduce, ``rmsnorm`` with the reduced statistic:
``models.recurrent._cell_norm``), so such a block launches K1 three
times, not two; every other norm, an sLSTM cell's included, launches K1
once.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import cost
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.linear_recurrence import ops as linrec_ops
from repro_torch.kernels.linear_recurrence import ref as linrec_ref
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm import ref as rmsnorm_ref

BACKENDS = ("auto", "torch")


class _State(threading.local):
    def __init__(self):
        self.backend = "auto"


_STATE = _State()


@contextlib.contextmanager
def use_backend(backend: str):
    """``"auto"``: kernels for CUDA tensors; ``"torch"``: plain versions."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    prev = _STATE.backend
    _STATE.backend = backend
    try:
        yield
    finally:
        _STATE.backend = prev


def _kernel(x) -> bool:
    return x.is_cuda and _STATE.backend == "auto"


def flash_attention(q, k, v, *, q_positions, k_positions, causal, window=0,
                    softcap=0.0):
    kw = dict(q_positions=q_positions, k_positions=k_positions, causal=causal,
              window=window, softcap=softcap)
    if _kernel(q):
        return flash_ops.flash_attention(q, k, v, **kw)
    if cost.tracking(q):
        return cost.as_kernel(lambda q, k, v: flash_ref.plain_attention(q, k, v, **kw),
                              (q, k, v))
    return flash_ref.plain_attention(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, *, q_positions, k_positions,
                     window=0, softcap=0.0):
    kw = dict(q_positions=q_positions, k_positions=k_positions, window=window,
              softcap=softcap)
    if _kernel(q):
        return decode_ops.decode_attention(q, k_cache, v_cache, **kw)
    if cost.tracking(q):
        (B, _, Hq, D), (L, Hkv) = q.shape, k_cache.shape[1:3]
        return cost.as_kernel(lambda q: decode_ref.decode_attention(q, k_cache, v_cache, **kw),
                              (q,), decode_ops.workspace_bytes(B, Hq, Hkv, L, D, cost.CARD_SMS))
    return decode_ref.decode_attention(q, k_cache, v_cache, **kw)


def paged_decode_attention(q, k_pool, v_pool, *, block_tables, q_positions,
                           window=0, softcap=0.0, q_head0=0, group=0):
    """Query head h of ``q`` reads pool head ``(q_head0 + h) // group``
    (``group`` 0: Hq / Hkv of the call, every pool head in order)."""
    kw = dict(block_tables=block_tables, q_positions=q_positions, window=window,
              softcap=softcap, q_head0=q_head0, group=group)
    if _kernel(q):
        return decode_ops.paged_decode_attention(q, k_pool, v_pool, **kw)
    if cost.tracking(q):
        B, _, Hq, D = q.shape
        heads = decode_ref.pool_heads(Hq, k_pool.shape[2], q_head0, group)
        L = block_tables.shape[1] * k_pool.shape[1]
        return cost.as_kernel(
            lambda q: decode_ref.paged_decode_attention(q, k_pool, v_pool, **kw), (q,),
            decode_ops.workspace_bytes(B, Hq, heads.stop - heads.start, L, D, cost.CARD_SMS))
    return decode_ref.paged_decode_attention(q, k_pool, v_pool, **kw)


def linear_recurrence(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t over axis 1.  a, b: (B, S, W) fp32; h0: (B, W)."""
    if _kernel(a):
        return linrec_ops.linear_recurrence(a, b, h0)
    if cost.tracking(a):
        return cost.as_kernel(linrec_ref.linear_recurrence, (a, b, h0),
                              linrec_ops.workspace_bytes(*a.shape, cost.CARD_SMS))
    return linrec_ref.linear_recurrence(a, b, h0)


def rmsnorm(x, scale, eps=1e-6, stat=None, width=0):
    """K1; with ``stat`` (x's rows, fp32), the mean of squares is ``stat /
    width`` (a width the ranks split, ``rmsnorm_sumsq``'s sums reduced)."""
    if _kernel(x):
        return rmsnorm_ops.rmsnorm(x, scale, eps=eps, stat=stat, width=width)
    if cost.tracking(x):
        if stat is None:
            return cost.as_kernel(lambda x, s: rmsnorm_ref.rmsnorm(x, s, eps=eps), (x, scale))
        return cost.as_kernel(lambda x, s, st: rmsnorm_ref.rmsnorm(x, s, eps=eps, stat=st,
                                                                  width=width),
                              (x, scale, stat))
    return rmsnorm_ref.rmsnorm(x, scale, eps=eps, stat=stat, width=width)


def rmsnorm_sumsq(x):
    """Each row's fp32 sum of squares over the last dim: K1's statistic."""
    if _kernel(x):
        return rmsnorm_ops.rmsnorm_sumsq(x)
    if cost.tracking(x):
        return cost.as_kernel(rmsnorm_ref.sumsq, (x,))
    return rmsnorm_ref.sumsq(x)


def add_rmsnorm(x, r, scale, eps=1e-6):
    """``(x + r, rmsnorm(x + r))``: the residual add fused into K1."""
    if _kernel(x):
        return rmsnorm_ops.add_rmsnorm(x, r, scale, eps=eps)
    if cost.tracking(x):
        return cost.as_kernel(lambda x, r, s: rmsnorm_ref.add_rmsnorm(x, r, s, eps=eps),
                              (x, r, scale))
    return rmsnorm_ref.add_rmsnorm(x, r, scale, eps=eps)


# every kernel wrapper, each with its ``launches`` count
KERNELS = {"flash_attention": flash_ops.flash_attention,
           "decode_attention": decode_ops.decode_attention,
           "paged_decode_attention": decode_ops.paged_decode_attention,
           "rmsnorm": rmsnorm_ops.rmsnorm,
           "linear_recurrence": linrec_ops.linear_recurrence}


def capture_graph(fn: Callable[[], object], device
                  ) -> Tuple[torch.cuda.CUDAGraph, object, Dict[str, int]]:
    """Capture ``fn()`` once as a CUDA graph, the way every captured step of
    the port is: two runs on a side stream first build and first-launch the
    kernels and make cuBLAS pick its algorithms, then the capture.  A
    replay launches what the capture recorded, so the capture's launches
    are taken back from each kernel's count, to be credited per replay
    (``credit``).  Returns (graph, what the captured call returned,
    launches per replay).  A capture that fails raises."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    before = {name: k.launches for name, k in KERNELS.items()}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    launches = {}
    for name, k in KERNELS.items():
        launches[name] = k.launches - before[name]
        k.launches = before[name]
    return graph, out, launches


def credit(launches: Dict[str, int]) -> None:
    """Count one replay of a captured graph: ``launches`` from
    ``capture_graph``."""
    for name, n in launches.items():
        KERNELS[name].launches += n
