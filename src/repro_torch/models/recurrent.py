"""Recurrent blocks, the counterpart of ``repro/models/recurrent.py``:
Griffin's RG-LRU (RecurrentGemma) and the xLSTM cells mLSTM and sLSTM.

The RG-LRU block: a GeLU gate branch ``x @ in_g`` and a recurrent branch
``x @ in_x`` -> depthwise causal conv (width K) -> per-timestep decay
``a = exp(-8 softplus(lambda) r)`` and normalised input
``b = sqrt(1 - a^2) (i * xc)`` from block-diagonal gates -> the linear
recurrence ``h_t = a_t h_{t-1} + b_t`` in fp32 (``dispatch.linear_recurrence``,
the K5 kernel on the GPU) -> ``(h * gate) @ out``.

The arithmetic keeps the reference's order step for step (the conv's
shifted adds, ``softplus`` as ``logaddexp(x, 0)``, the clip inside the
square root, ``h`` cast to the activation dtype before the gate multiply),
so fp32 runs on the CPU agree with the reference to rounding.

The mLSTM cell (xLSTM's matrix memory; nemotron-h-8b's stand-in for
Mamba-2): up-projections ``u`` and ``z`` to width W = d * proj_factor,
a causal conv and SiLU on ``u``, block-diagonal q/k (from the conv'd
branch) and v (from ``u``), log input and forget gates per head, and the
stabilized matrix-memory recurrence in fp32, chunkwise-parallel over a
sequence (``_mlstm_chunk_scan``: a Python loop over chunks of static
shape, so a CUDA graph can capture it) and O(1) per decode step; then
``rms_norm`` over W (K1 on the GPU), the SiLU(z) gate and the down
projection.  The sLSTM cell (scalar memory with recurrent gate weights)
is a loop over time steps in both cases (folded into one pass for
counting on ``meta``: ``_slstm_folded``).  Neither cell has a kernel of
its own: their products are plain ``matmul``/``einsum``, and only their
norms go through a kernel (K1).

The state a layer carries is its cache entry (``cache.init_rglru_state``,
``init_mlstm_state``, ``init_slstm_state``).  The functions here return
the new state as fresh tensors; ``models.model`` writes it into the entry
in place.

Tensor parallelism (a module built with ``shards`` > 1, its mesh in
``p.tp``), on the reference's serving rules (``sharding/rules.py``):

* RG-LRU: the rank projects and convolves its slice of the LRU width W
  (the conv is depthwise, so it stays local) and carries its slice of
  ``h`` and ``conv``.  The block-diagonal gates shard their input rows,
  every head's, so the rank gathers the conv output over W, forms its
  partial products over its own rows for every head, all-reduces them
  (fp32) and keeps its own W columns; K5 then runs on (B, S, W / tp), and
  ``out`` is row-parallel.  This holds where the heads straddle ranks
  (10 heads over 4 ranks).
* mLSTM: the rank's slice of W (up-projections, conv, ``norm_scale``,
  ``down``); q, k and v come from the gathered branches by the same
  partial-then-reduce products, the log gates from the row-parallel
  ``w_i``/``w_f`` (the fp32 partials reduced before the biases), all in
  one all-reduce; the cell then runs on the rank's H / tp heads, whose
  ``C``, ``n``, ``m`` it carries.  The cell norm over the whole W is
  K1's two split launches, the rank's fp32 sums of squares all-reduced
  between them (K1 over the slice alone would normalise another vector).
* sLSTM: the gates and recurrent weights replicate, so the cell runs
  whole on every rank; its state is held as the cache lays it out
  (``c``, ``n``, ``m``, ``h`` on heads, ``conv`` on d), gathered once at
  the start of a call and the rank's slice stored at its end.  ``ff_up``
  and ``ff_down`` are column- and row-parallel where tp divides the FFN
  width, else whole.

A dim tp does not divide is whole on every rank, and so is the output of
a block whose width is whole (``p.partial`` False); an mLSTM whose heads
tp does not divide runs its cell whole from its gathered state, as the
sLSTM does.  Under grad the collectives are ``sharding.collectives``': a
split block's input, a gathered row before the rank's rows or columns of
it, the cell's heads and the cell norm's reduced statistic are
``copy``'d where a rank's own arithmetic reads them, so every gradient
that reaches a replicated tensor is summed over the ranks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models import flags
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn, init_normal_, matmul_fp32, new_param, rms_norm
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import cache_dim, divides, local_size

# a pad step's log input gate: below the -1e30 a stabilizer starts at, so
# an identity step contributes nothing even to a fresh state
_PAD_LOG_I = -2e30


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

    def __init__(self, cfg: ModelConfig, dtype, device, shards: int = 1):
        super().__init__()
        d, W, H = cfg.d_model, cfg.resolved_lru_width, cfg.resolved_rec_heads
        Dh = W // H
        # a shard's output is one rank's partial sum, kept in fp32 for the
        # sum over the ranks, where the width is split
        self.partial = divides(shards, W)
        self.tp = None  # the mesh of a tensor-parallel shard (set by ``Model``)
        Wl, Dr = local_size(W, shards), local_size(Dh, shards)
        self.in_x = new_param((d, Wl), dtype, device)
        self.in_g = new_param((d, Wl), dtype, device)
        self.conv_w = new_param((cfg.rglru_conv_width, Wl), dtype, device)
        self.gate_a = new_param((H, Dr, Dh), dtype, device)
        self.gate_x = new_param((H, Dr, Dh), dtype, device)
        self.register_parameter("lambda", new_param((Wl,), dtype, device))
        self.out = new_param((Wl, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.in_x, gen)
        init_normal_(self.in_g, gen)
        init_normal_(self.conv_w, gen, scale=0.1)
        dh = self.gate_a.shape[2]
        init_normal_(self.gate_a, gen, scale=1.0 / math.sqrt(dh))
        init_normal_(self.gate_x, gen, scale=1.0 / math.sqrt(dh))
        lam = getattr(self, "lambda")
        lam.copy_(torch.from_numpy(lambda_init(lam.shape[0])))
        init_normal_(self.out, gen, scale=1.0 / math.sqrt(self.out.shape[0]))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, history: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width K by shifted adds: x (B, S, W), w
    (K, W), ``history`` (B, K-1, W) the previous inputs.  Returns (y,
    new_history), the new history being the last K-1 inputs.

    ``lengths`` (B,) marks each row's valid prefix of ``x``: the new
    history is then each row's last K-1 *valid* inputs, so ragged rows of
    a packed chunk carry the right conv state (a row of length 0 keeps
    its old history).  Outputs at pad positions are garbage."""
    K = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([history.to(x.dtype), x], dim=1)  # (B, S+K-1, W)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xp[:, i:i + S] * w[K - 1 - i]
    if K <= 1:
        return y, history
    if lengths is None:
        return y, xp[:, S:]
    idx = lengths.long()[:, None] + torch.arange(K - 1, device=x.device)[None]
    return y, torch.gather(xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))


def _block_diag_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., H*Dh) @ block-diagonal w (H, Dh, Do) -> (..., H*Do)."""
    H, Dh, Do = w.shape
    xh = x.reshape(*x.shape[:-1], H, Dh)
    y = torch.einsum("...hd,hdo->...ho", xh, w)
    return y.reshape(*x.shape[:-1], H * Do)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _row_partials(tp, x: torch.Tensor, ws) -> torch.Tensor:
    """The rank's fp32 partial block-diagonal products of the whole ``x``
    (..., H * Dh) with weights ``ws`` (each (H, rows, Do)) that hold its
    ``rows`` of each head's Dh input rows: (..., n, H, Do), n = len(ws).
    Summed over the ranks and rounded to x's dtype they are the products
    of the whole weights, rounded once as one product rounds."""
    H, rows, _ = ws[0].shape
    x = collectives.copy(x, tp)
    xh = x.reshape(*x.shape[:-1], H, -1)[..., tp.rank * rows:(tp.rank + 1) * rows].float()
    return torch.einsum("...hd,nhde->...nhe", xh, torch.stack(ws).float())


def _block_diag_gathered(p, x: torch.Tensor, ws) -> torch.Tensor:
    """The block-diagonal products ``ws`` of a shard's slice ``x`` (..., W /
    tp) of the width, whole: x gathered over the ranks, then the products
    of the whole row (partial over the rank's input rows, and reduced,
    where the weights split them); (..., n, W)."""
    full = collectives.gather(x, -1, p.tp)
    if ws[0].shape[1] < ws[0].shape[2]:
        part = collectives.reduce(_row_partials(p.tp, full, ws), p.tp)
        return part.to(x.dtype).reshape(*x.shape[:-1], len(ws), -1)
    return torch.stack([_block_diag_linear(full, w) for w in ws], dim=-2)


def _own_cols(p, t: torch.Tensor, n: int) -> torch.Tensor:
    """The rank's ``n`` columns of the width ``t`` (..., W)."""
    return collectives.copy(t, p.tp)[..., p.tp.rank * n:(p.tp.rank + 1) * n]


def _rglru_gates(p: RGLRU, xc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-timestep decay a and gated, normalised input b (both fp32) from
    the conv'd branch xc (a shard's slice of the width)."""
    if p.partial:
        pre = _own_cols(p, _block_diag_gathered(p, xc, (p.gate_a, p.gate_x)), xc.shape[-1])
        ra, rx = pre[..., 0, :], pre[..., 1, :]
    else:
        ra, rx = _block_diag_linear(xc, p.gate_a), _block_diag_linear(xc, p.gate_x)
    r = torch.sigmoid(ra.float())
    i = torch.sigmoid(rx.float())
    log_a = -8.0 * _softplus(getattr(p, "lambda").float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalization (Griffin eq. 4)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    b = beta * (i * xc.float())
    return a, b


def apply_rglru_seq(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                    state: Dict[str, torch.Tensor],
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) from ``state`` (a cache entry).  Returns (y (B, S, d),
    new_state): the state after the last step, as fresh tensors.

    ``valid`` (B, S) bool marks each row's valid prefix of a packed chunk:
    pad steps are identity (a = 1, b = 0), so ``h[:, -1]`` is the state
    after each row's last valid input, and a row with none keeps its
    state bit for bit."""
    if p.partial:
        x = collectives.copy(x, p.tp)
    g = act_fn("gelu")(torch.matmul(x, p.in_g))
    xr = torch.matmul(x, p.in_x)
    lengths = None if valid is None else valid.sum(dim=1, dtype=torch.int32)
    xc, conv_hist = _causal_conv(xr, p.conv_w, state["conv"], lengths)
    a, b = _rglru_gates(p, xc)
    if valid is not None:
        m = valid[..., None]
        a = torch.where(m, a, 1.0)
        b = torch.where(m, b, 0.0)
    h = dispatch.linear_recurrence(a, b, state["h"])  # (B, S, W) fp32
    y = (matmul_fp32 if p.partial else torch.matmul)(h.to(x.dtype) * g, p.out)
    return y, {"h": h[:, -1], "conv": conv_hist}


def apply_rglru_step(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                     state: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, d): one decode step against the carried state."""
    return apply_rglru_seq(p, x, cfg, state)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell, chunkwise-parallel)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """mLSTM parameters, named like the reference's ``make_mlstm_block``
    leaves."""

    def __init__(self, cfg: ModelConfig, dtype, device, shards: int = 1):
        super().__init__()
        d = cfg.d_model
        W = int(d * cfg.mlstm_proj_factor)
        H = cfg.resolved_rec_heads
        D = W // H
        # a shard's output is one rank's partial sum, kept in fp32 for the
        # sum over the ranks, where the width is split; its cell runs on
        # its own heads where those split too
        self.partial = divides(shards, W)
        self.heads_split = self.partial and divides(shards, H)
        self.tp = None  # the mesh of a tensor-parallel shard (set by ``Model``)
        Wl, Dr = local_size(W, shards), local_size(D, shards)
        self.up_u = new_param((d, Wl), dtype, device)
        self.up_z = new_param((d, Wl), dtype, device)
        self.conv_w = new_param((cfg.rglru_conv_width, Wl), dtype, device)
        self.wq = new_param((H, Dr, D), dtype, device)
        self.wk = new_param((H, Dr, D), dtype, device)
        self.wv = new_param((H, Dr, D), dtype, device)
        self.w_i = new_param((Wl, H), dtype, device)
        self.b_i = new_param((H,), dtype, device)
        self.w_f = new_param((Wl, H), dtype, device)
        self.b_f = new_param((H,), dtype, device)
        self.norm_scale = new_param((Wl,), dtype, device)
        self.down = new_param((Wl, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        init_normal_(self.up_u, gen)
        init_normal_(self.up_z, gen)
        init_normal_(self.conv_w, gen, scale=0.1)
        dh = self.wq.shape[2]
        for w in (self.wq, self.wk, self.wv):
            init_normal_(w, gen, scale=1.0 / math.sqrt(dh))
        init_normal_(self.w_i, gen, scale=0.01)
        init_normal_(self.w_f, gen, scale=0.01)
        self.b_i.zero_()
        self.b_f.copy_(torch.linspace(3.0, 6.0, self.b_f.shape[0]))  # long-memory init
        self.norm_scale.zero_()
        init_normal_(self.down, gen, scale=1.0 / math.sqrt(self.down.shape[0]))


def _mlstm_chunk_out(qc, kc, vc, li, lf, C, n, m, causal, scale):
    """One chunk's output from the state carried into it: h (..., H, L, D)
    fp32, and the chunk's log-decays and stabilizers its state update
    takes.  qc, kc, vc (..., H, L, D); li, lf (..., H, L); C (..., H, D, D),
    n (..., H, D), m (..., H).  Leading axes broadcast."""
    b = torch.cumsum(lf, dim=-1)            # inclusive log-decay to t
    a = li - b                              # a_s = log_i_s - b_s
    mm = torch.maximum(m[..., None], torch.cummax(a, dim=-1).values)   # (..., L)
    m_t = b + mm
    # intra-chunk scores
    s_qk = torch.matmul(qc, kc.transpose(-1, -2)) * scale
    decay = a[..., None, :] - mm[..., :, None]                          # (..., L(t), L(s))
    w_intra = torch.where(causal, torch.exp(decay), 0.0)
    h_intra = torch.matmul(s_qk * w_intra, vc)
    n_intra = torch.matmul(w_intra, kc)     # normalizer state at t
    # inter-chunk (carry) contribution
    w_inter = torch.exp(m[..., None] - mm)                              # (..., L)
    qs = qc * scale
    h_inter = torch.matmul(qs, C) * w_inter[..., None]
    num = h_intra + h_inter
    # denominator: |q.n_t| with n_t the stabilized normalizer state at t
    n_at_t = n_intra + n[..., None, :] * w_inter[..., None]
    denom = torch.abs((qs * n_at_t).sum(-1))
    denom = torch.maximum(denom, torch.exp(-m_t))
    return num / denom[..., None], b, a, m_t


def _mlstm_chunk_state(kc, vc, b, a, m_t, C, n, m):
    """The state after a chunk; sum_l w_c k_l v_l^T as one (D,L)@(L,D)
    product.  Leading axes broadcast."""
    g = b[..., -1]
    m_next = m_t[..., -1]
    w_c = torch.exp(g[..., None] + a - m_next[..., None])              # (..., L)
    carry = torch.exp(g + m - m_next)
    wk = w_c[..., None] * kc
    C = carry[..., None, None] * C + torch.matmul(wk.transpose(-1, -2), vc)
    n = carry[..., None] * n + wk.sum(dim=-2)
    return C, n, m_next


def _mlstm_chunk_scan(q, k, v, log_i, log_f, state: Dict[str, torch.Tensor], chunk: int):
    """Chunkwise-parallel stabilized mLSTM, the reference's arithmetic step
    for step.  q, k, v (B, S, H, D) fp32; log_i, log_f (B, S, H) fp32;
    state ``C`` (B, H, D, D), ``n`` (B, H, D), ``m`` (B, H).  Returns h
    (B, S, H, D) fp32 and the final state.  A ragged last chunk is padded
    with identity steps (log_f = 0 keeps the carry, log_i = -2e30 adds
    nothing)."""
    B, S, H, D = q.shape
    L = min(chunk, S)
    S_orig = S
    if S % L:
        pad = L - S % L
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=_PAD_LOG_I)
        S += pad
    C, n, m = state["C"], state["n"], state["m"]
    scale = 1.0 / math.sqrt(D)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    if flags.fold_loops():
        h, C, n, m = _mlstm_folded(q, k, v, log_i, log_f, C, n, m, L, causal, scale)
        return h[:, :S_orig].contiguous(), {"C": C, "n": n, "m": m}
    hs = []
    for c0 in range(0, S, L):
        qc, kc, vc = (t[:, c0:c0 + L].transpose(1, 2) for t in (q, k, v))  # (B,H,L,D)
        li, lf = (t[:, c0:c0 + L].transpose(1, 2) for t in (log_i, log_f))  # (B,H,L)
        h, b, a, m_t = _mlstm_chunk_out(qc, kc, vc, li, lf, C, n, m, causal, scale)
        hs.append(h.transpose(1, 2))                                       # (B,L,H,D)
        C, n, m = _mlstm_chunk_state(kc, vc, b, a, m_t, C, n, m)
    # contiguous: a padded tail's slice would leave the cell norm (K1,
    # which takes contiguous rows) a strided view in fp32
    h = torch.cat(hs, dim=1)[:, :S_orig].contiguous()
    return h, {"C": C, "n": n, "m": m}


def _mlstm_folded(q, k, v, log_i, log_f, C, n, m, L, causal, scale):
    """The chunk loop for counting (``flags.fold_loops``): chunk 0 from the
    carried state, as the loop takes it, then chunks 1 .. N - 1 as one
    batch axis from chunk 0's state broadcast.  Every product keeps its
    shape in the loop.  So that the backward forms what the loop's does,
    the outputs also depend, with weight 0, on the state updates of chunks
    1 .. N - 2 (whose states later chunks read); the last chunk's update,
    which only the final state reads, is a product of its own.  The values
    are not the loop's: meta tensors only.  Returns h (B, N L, H, D) and
    the final state."""
    if q.device.type != "meta":
        raise ValueError("folded mLSTM loops count products on the meta device only")
    B, S, H, D = q.shape
    N = S // L
    qs, ks, vs = (t.reshape(B, N, L, H, D).transpose(2, 3) for t in (q, k, v))  # (B,N,H,L,D)
    lis, lfs = (t.reshape(B, N, L, H).transpose(2, 3) for t in (log_i, log_f))  # (B,N,H,L)
    h0, b, a, m_t = _mlstm_chunk_out(qs[:, 0], ks[:, 0], vs[:, 0], lis[:, 0], lfs[:, 0],
                                     C, n, m, causal, scale)
    C, n, m = _mlstm_chunk_state(ks[:, 0], vs[:, 0], b, a, m_t, C, n, m)
    h0 = h0.transpose(1, 2)                                                # (B,L,H,D)
    if N == 1:
        return h0, C, n, m
    C, n, m = (t[:, None] for t in (C, n, m))
    h, b, a, m_t = _mlstm_chunk_out(qs[:, 1:], ks[:, 1:], vs[:, 1:], lis[:, 1:], lfs[:, 1:],
                                    C, n, m, causal, scale)
    if N > 2:
        mid = _mlstm_chunk_state(ks[:, 1:-1], vs[:, 1:-1], b[:, :-1], a[:, :-1],
                                 m_t[:, :-1], C, n, m)[0]
        h = h + 0.0 * mid.sum()
    C, n, m = (t[:, 0] for t in _mlstm_chunk_state(ks[:, -1:], vs[:, -1:], b[:, -1:], a[:, -1:],
                                                   m_t[:, -1:], C, n, m))
    h = h.permute(0, 1, 3, 2, 4).reshape(B, (N - 1) * L, H, D)
    return torch.cat([h0, h], dim=1), C, n, m


def _mlstm_qkv_gates(p: MLSTM, u: torch.Tensor, uc: torch.Tensor, H: int, D: int):
    """q, k, v (B, S, H, D) and the log gates (B, S, H), all fp32 and over
    every head, from the up-projected ``u`` and its conv'd, SiLU'd ``uc``
    (a shard's slices of the width: gathered for the block-diagonal
    products, whose partials are reduced with the row-parallel gates'
    in one all-reduce)."""
    B, S = u.shape[:2]
    if not p.partial:
        q = _block_diag_linear(uc, p.wq).reshape(B, S, H, D).float()
        k = _block_diag_linear(uc, p.wk).reshape(B, S, H, D).float()
        v = _block_diag_linear(u, p.wv).reshape(B, S, H, D).float()
        log_i = (torch.matmul(uc, p.w_i) + p.b_i).float()
        log_f = F.logsigmoid((torch.matmul(uc, p.w_f) + p.b_f).float())
        return q, k, v, log_i, log_f
    both = collectives.gather(torch.stack([uc, u], dim=-2), -1, p.tp)  # (B, S, 2, W)
    gates = matmul_fp32(uc, torch.cat([p.w_i, p.w_f], dim=-1))      # (B, S, 2H) partial
    if p.wq.shape[1] < D:  # the products' input rows split: one reduce with the gates'
        qk = _row_partials(p.tp, both[:, :, 0], (p.wq, p.wk))
        v = _row_partials(p.tp, both[:, :, 1], (p.wv,))
        flat = torch.cat([qk.reshape(B, S, -1), v.reshape(B, S, -1), gates], dim=-1)
        flat = collectives.reduce(flat, p.tp)
        qkv = flat[..., :3 * H * D].to(u.dtype).float().reshape(B, S, 3, H, D)
        q, k, v = qkv.unbind(2)
        gates = flat[..., 3 * H * D:]
    else:
        q = _block_diag_linear(both[:, :, 0], p.wq).reshape(B, S, H, D).float()
        k = _block_diag_linear(both[:, :, 0], p.wk).reshape(B, S, H, D).float()
        v = _block_diag_linear(both[:, :, 1], p.wv).reshape(B, S, H, D).float()
        gates = collectives.reduce(gates, p.tp)
    gates = gates.to(u.dtype)
    log_i = (gates[..., :H] + p.b_i).float()
    log_f = F.logsigmoid((gates[..., H:] + p.b_f).float())
    return q, k, v, log_i, log_f


def _cell_norm(p, h: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm(h, norm_scale)`` over the whole width of a shard's slice
    ``h`` (..., W / tp): K1's split launches, the slice's fp32 sums of
    squares all-reduced between them."""
    ss = collectives.reduce(dispatch.rmsnorm_sumsq(h), p.tp)
    return dispatch.rmsnorm(h, p.norm_scale, eps, stat=collectives.copy(ss, p.tp),
                            width=h.shape[-1] * p.tp.size)


def _mlstm_out(p: MLSTM, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The cell's output: ``rms_norm`` over W (K1; a shard's from its
    reduced statistic), the SiLU(z) gate, the down projection (a shard's
    fp32 partial)."""
    if p.partial:
        return matmul_fp32(_cell_norm(p, h) * act_fn("silu")(z), p.down)
    h = rms_norm(h, p.norm_scale, 1e-6)
    return torch.matmul(h * act_fn("silu")(z), p.down)


def _gathered_state(p, state: Dict[str, torch.Tensor], full: Dict[str, Tuple[int, ...]]):
    """The leaves ``full`` names of a shard's ``state``, whole: each
    gathered over the ranks along the dim its cache entry splits
    (``sharding.rules.cache_dim`` at its full shape), leaves of one
    shape and dim in one collective."""
    out, groups = {}, {}
    for leaf, shape in full.items():
        dim = cache_dim(leaf, shape, p.tp.size)
        if dim is None:
            out[leaf] = state[leaf]
        else:
            groups.setdefault((dim, state[leaf].dtype, tuple(state[leaf].shape)), []).append(leaf)
    for (dim, _, _), leaves in groups.items():
        whole = collectives.gather(torch.stack([state[leaf] for leaf in leaves]), dim + 1, p.tp)
        out.update(zip(leaves, whole.unbind(0)))
    return out


def _own_state(p, state: Dict[str, torch.Tensor], full: Dict[str, Tuple[int, ...]]):
    """The rank's slices of whole state leaves: ``_gathered_state``'s
    inverse."""
    out = dict(state)
    for leaf, shape in full.items():
        dim = cache_dim(leaf, shape, p.tp.size)
        if dim is not None:
            n = shape[dim] // p.tp.size
            out[leaf] = state[leaf].narrow(dim, p.tp.rank * n, n)
    return out


def _mlstm_cell_state(p: MLSTM, state: Dict[str, torch.Tensor], B: int, H: int, D: int):
    """The leaves of a shard's mLSTM state that its cell carries whole
    (heads tp does not divide), with their full shapes; none where the
    cell runs on the rank's heads or without tensor parallelism."""
    if p.tp is None or p.heads_split or not p.partial:
        return {}
    return {"C": (B, H, D, D), "n": (B, H, D), "m": (B, H)}


def _mlstm_heads(p: MLSTM, *ts):
    """The rank's heads of (B, S, H, ...) tensors where the cell runs on
    them, else the tensors as they are."""
    if not p.heads_split:
        return ts
    n = ts[0].shape[2] // p.tp.size
    return tuple(collectives.copy(t, p.tp)[:, :, p.tp.rank * n:(p.tp.rank + 1) * n] for t in ts)


def apply_mlstm_seq(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                    state: Dict[str, torch.Tensor],
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) from ``state`` (a cache entry).  Returns (y, new_state).
    ``valid`` (B, S) bool marks each row's valid prefix of a packed chunk:
    pad steps are identity (log_f = 0, log_i = -2e30), so the state is
    that after each row's last valid input."""
    B, S, d = x.shape
    W = int(d * cfg.mlstm_proj_factor)
    H = cfg.resolved_rec_heads
    D = W // H
    if p.partial:
        x = collectives.copy(x, p.tp)
    u = torch.matmul(x, p.up_u)
    z = torch.matmul(x, p.up_z)
    lengths = None if valid is None else valid.sum(dim=1, dtype=torch.int32)
    uc, conv_hist = _causal_conv(u, p.conv_w, state["conv"], lengths)
    uc = act_fn("silu")(uc)
    q, k, v, log_i, log_f = _mlstm_heads(p, *_mlstm_qkv_gates(p, u, uc, H, D))
    if valid is not None:
        m = valid[..., None]
        log_f = torch.where(m, log_f, 0.0)
        log_i = torch.where(m, log_i, _PAD_LOG_I)
    whole = _mlstm_cell_state(p, state, B, H, D)
    if whole:
        state = _gathered_state(p, state, whole)
    h, cell = _mlstm_chunk_scan(q, k, v, log_i, log_f, state, cfg.recurrent_chunk)
    h = h.reshape(B, S, -1).to(x.dtype)
    if whole:
        h, cell = _own_cols(p, h, u.shape[-1]), _own_state(p, cell, whole)
    return _mlstm_out(p, h, z), {**cell, "conv": conv_hist}


def apply_mlstm_step(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                     state: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, d): one decode step, an O(1) update of the matrix memory."""
    B, _, d = x.shape
    W = int(d * cfg.mlstm_proj_factor)
    H = cfg.resolved_rec_heads
    D = W // H
    if p.partial:
        x = collectives.copy(x, p.tp)
    u = torch.matmul(x, p.up_u)
    z = torch.matmul(x, p.up_z)
    uc, conv_hist = _causal_conv(u, p.conv_w, state["conv"])
    uc = act_fn("silu")(uc)
    q, k, v, log_i, log_f = (t[:, 0] for t in _mlstm_heads(p, *_mlstm_qkv_gates(p, u, uc, H, D)))
    whole = _mlstm_cell_state(p, state, B, H, D)
    if whole:
        state = _gathered_state(p, state, whole)
    scale = 1.0 / math.sqrt(D)
    m_new = torch.maximum(log_f + state["m"], log_i)
    w_old = torch.exp(log_f + state["m"] - m_new)
    w_in = torch.exp(log_i - m_new)
    C = w_old[..., None, None] * state["C"] + w_in[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = w_old[..., None] * state["n"] + w_in[..., None] * k
    qs = q * scale
    num = torch.matmul(qs[..., None, :], C)[..., 0, :]
    denom = torch.maximum(torch.abs((qs * n).sum(-1)), torch.exp(-m_new))
    h = (num / denom[..., None]).reshape(B, 1, -1).to(x.dtype)
    cell = {"C": C, "n": n, "m": m_new}
    if whole:
        h, cell = _own_cols(p, h, u.shape[-1]), _own_state(p, cell, whole)
    return _mlstm_out(p, h, z), {**cell, "conv": conv_hist}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory cell, sequential)
# ---------------------------------------------------------------------------

SLSTM_GATES = ("z", "i", "f", "o")


class SLSTM(nn.Module):
    """sLSTM parameters, named like the reference's ``make_slstm_block``
    leaves: per gate an input weight ``w_<g>`` (d, d), a block-diagonal
    recurrent weight ``r_<g>`` (H, Dh, Dh) and a bias ``b_<g>`` (H, Dh)."""

    def __init__(self, cfg: ModelConfig, dtype, device, shards: int = 1):
        super().__init__()
        d = cfg.d_model
        H = cfg.resolved_rec_heads
        Dh = d // H
        ff = int(d * cfg.slstm_proj_factor)
        # a shard's output is one rank's partial sum, kept in fp32 for the
        # sum over the ranks, where the FFN width is split; the cell itself
        # runs whole on every rank
        self.partial = divides(shards, ff)
        self.tp = None  # the mesh of a tensor-parallel shard (set by ``Model``)
        ff = local_size(ff, shards)
        for g in SLSTM_GATES:
            setattr(self, f"w_{g}", new_param((d, d), dtype, device))
            setattr(self, f"r_{g}", new_param((H, Dh, Dh), dtype, device))
            setattr(self, f"b_{g}", new_param((H, Dh), dtype, device))
        self.conv_w = new_param((cfg.rglru_conv_width, d), dtype, device)
        self.norm_scale = new_param((d,), dtype, device)
        self.ff_up = new_param((d, ff), dtype, device)
        self.ff_down = new_param((ff, d), dtype, device)

    def init_(self, gen: torch.Generator) -> None:
        for g in SLSTM_GATES:
            init_normal_(getattr(self, f"w_{g}"), gen)
            r = getattr(self, f"r_{g}")
            init_normal_(r, gen, scale=1.0 / math.sqrt(r.shape[1]))
            b = getattr(self, f"b_{g}")
            if g == "f":
                b.copy_(torch.linspace(3.0, 6.0, b.numel()).reshape(b.shape))
            else:
                b.zero_()
        init_normal_(self.conv_w, gen, scale=0.1)
        self.norm_scale.zero_()
        init_normal_(self.ff_up, gen)
        init_normal_(self.ff_down, gen, scale=1.0 / math.sqrt(self.ff_down.shape[0]))


def _slstm_cell(p: SLSTM, carry, xs):
    """One time step.  carry (c, n, m, h), each (B, H, Dh) fp32; xs the
    gates' pre-activations from the input, (B, H, Dh) in the activation
    dtype, to which ``h`` is cast before the recurrent products.  Leading
    axes broadcast: ``_slstm_folded`` runs it once over (B, S - 1, H, Dh)."""
    c, n, m, h = carry
    zx, ix, fx, ox = xs
    hx = h.to(zx.dtype)

    def rec(g):
        return torch.einsum("...hd,hde->...he", hx, getattr(p, f"r_{g}")).float()

    z = torch.tanh(zx.float() + rec("z"))
    log_i = ix.float() + rec("i")
    log_f = F.logsigmoid(fx.float() + rec("f"))
    o = torch.sigmoid(ox.float() + rec("o"))
    m_new = torch.maximum(log_f + m, log_i)
    c_new = torch.exp(log_f + m - m_new) * c + torch.exp(log_i - m_new) * z
    n_new = torch.clamp(torch.exp(log_f + m - m_new) * n + torch.exp(log_i - m_new), min=1e-6)
    h_new = o * (c_new / n_new)
    return (c_new, n_new, m_new, h_new)


def apply_slstm_seq(p: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                    state: Dict[str, torch.Tensor],
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) from ``state``: a Python loop over the S steps.
    ``valid`` (B, S) bool freezes a row's carry at its pad steps."""
    B, S, d = x.shape
    H = cfg.resolved_rec_heads
    Dh = d // H
    whole = {}
    if p.tp is not None:  # a shard's state, gathered whole for the call
        whole = {leaf: (B, H, Dh) for leaf in ("c", "n", "m", "h")}
        whole["conv"] = (B, cfg.rglru_conv_width - 1, d)
        state = _gathered_state(p, state, whole)
    lengths = None if valid is None else valid.sum(dim=1, dtype=torch.int32)
    xc, conv_hist = _causal_conv(x, p.conv_w, state["conv"], lengths)
    xc = act_fn("silu")(xc)
    pre = [torch.matmul(src, getattr(p, f"w_{g}")).reshape(B, S, H, Dh) + getattr(p, f"b_{g}")
           for g, src in zip(SLSTM_GATES, (x, xc, xc, x))]
    carry = (state["c"], state["n"], state["m"], state["h"])
    if flags.fold_loops():
        h, carry = _slstm_folded(p, carry, pre, x.device)
        h = h.reshape(B, S, d).to(x.dtype)
    else:
        hs = []
        for t in range(S):
            new = _slstm_cell(p, carry, [g[:, t] for g in pre])
            if valid is not None:
                v_t = valid[:, t, None, None]
                new = tuple(torch.where(v_t, nw, od) for nw, od in zip(new, carry))
            carry = new
            hs.append(carry[3])
        h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    c, n, m, h_fin = carry
    new = {"c": c, "n": n, "m": m, "h": h_fin, "conv": conv_hist}
    return _slstm_out(p, h), (_own_state(p, new, whole) if whole else new)


def _slstm_out(p: SLSTM, h: torch.Tensor) -> torch.Tensor:
    """The cell's output: ``rms_norm`` (K1), then its GeLU FFN (a shard's
    fp32 partial where its width is split)."""
    h = rms_norm(h, p.norm_scale, 1e-6)
    if not p.partial:
        return torch.matmul(act_fn("gelu")(torch.matmul(h, p.ff_up)), p.ff_down)
    h = collectives.copy(h, p.tp)
    return matmul_fp32(act_fn("gelu")(torch.matmul(h, p.ff_up)), p.ff_down)


def _slstm_folded(p: SLSTM, carry, pre, device: torch.device):
    """The time loop for counting (``flags.fold_loops``): step 0 from the
    carried state, as the loop takes it, then the cell once over steps 1
    .. S - 1 as a batch axis, from step 0's carry broadcast.  Each of those
    steps' products has its shape in the loop, and its carry needs a
    gradient whenever step 0's output does, so ``FlopCounterMode`` counts
    the loop's products forward and backward exactly.  The values are not
    the loop's: meta tensors only.  Returns h (B, S, H, Dh) and the last
    carry."""
    if device.type != "meta":
        raise ValueError("folded sLSTM loops count products on the meta device only")
    S = pre[0].shape[1]
    first = _slstm_cell(p, carry, [g[:, 0] for g in pre])
    if S == 1:
        return first[3][:, None], first
    rest = tuple(t[:, None].expand(-1, S - 1, -1, -1) for t in first)
    last = _slstm_cell(p, rest, [g[:, 1:] for g in pre])
    return torch.cat([first[3][:, None], last[3]], dim=1), tuple(t[:, -1] for t in last)


def apply_slstm_step(p: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                     state: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, 1, d): one decode step against the carried state."""
    return apply_slstm_seq(p, x, cfg, state)
