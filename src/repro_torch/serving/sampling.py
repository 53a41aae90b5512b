"""Token sampling for the serving engine, the counterpart of
``repro/serving/sampling.py``.

* ``sample``             — one ``SamplingParams`` for every row (the
  first token of a request, sampled from its prefill's logits).
* ``sample_slots_keyed`` — every row with its own temperature, top-k and
  random stream, all tensors: the sampler inside the engine's decode step.
* ``verify_slots_keyed`` — the speculative verify step's acceptance chain
  over a draft window, drawing each emitted token as the decode step would.

Greedy rows (temperature <= 0) take ``argmax``, as in the reference.  A
stochastic row draws from the temperature-scaled logits restricted to its
top-k set, by Gumbel-max with uniforms from a counter-based hash of
(request key, emitted-token index, vocabulary index).  The draw then
depends only on the request and how many tokens it has emitted, not on
which slot or step it ran in (scheduling invariance), and it needs no
generator state, so a CUDA graph can capture it.  The reference's
threefry draws cannot be matched bit for bit; the tests hold these draws
to the softmax they sample from instead.

The hash keeps every value below 2^32 and every product below 2^63, so it
is exact in int64 on every device (torch has no full uint64 arithmetic).
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
_WEYL = 0x9E3779B9  # spreads the vocabulary index before mixing


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> no top-k filter
    eos_token: int = -1          # -1 -> never stops early
    max_new_tokens: int = 64


def _mix32(x):
    """A 32-bit integer finalizer (xorshift-multiply, multipliers below
    2^31) on a Python int or an int64 tensor holding values < 2^32."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def request_key(seed: int, uid: int) -> int:
    """The 32-bit key of request ``uid``'s random stream under an engine
    seeded with ``seed``."""
    return _mix32(_mix32(seed & _M32) ^ _mix32((seed >> 32) & _M32) ^ _mix32(uid & _M32))


def _uniforms(keys: torch.Tensor, counts: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) float32 uniforms in (0, 1): a pure function of each row's
    key (B,) and emitted-token index (B,), both int64."""
    h = _mix32(keys ^ _mix32(counts & _M32))[:, None]
    v = torch.arange(vocab, dtype=torch.int64, device=keys.device)[None, :]
    bits = _mix32(_mix32((h + v * _WEYL) & _M32) ^ h)
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _mask_slot_logits(logits, temperature, top_k, k_max):
    """Temperature-scaled fp32 logits with everything below each row's
    k-th largest value set to -inf (ties kept; top_k 0: keep all).
    ``k_max`` is the static bound on per-row top-k."""
    k_max = min(k_max, logits.shape[-1])
    scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
    top_vals = torch.topk(scaled, k_max, dim=-1).values
    idx = (top_k - 1).clamp(0, k_max - 1)[:, None].long()
    cutoff = torch.where((top_k > 0)[:, None], top_vals.gather(-1, idx), -torch.inf)
    return torch.where(scaled < cutoff, -torch.inf, scaled)


def sample_slots_keyed(logits: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, keys: torch.Tensor, counts: torch.Tensor,
                       *, k_max: int = 64) -> torch.Tensor:
    """logits (B, V); temperature (B,) float32 (<= 0: greedy); top_k (B,)
    int32 (0: no filter); keys (B,) int64 request keys below 2^32; counts
    (B,) int64 emitted-token index of the draw -> tokens (B,) int64."""
    greedy = torch.argmax(logits, dim=-1)
    masked = _mask_slot_logits(logits, temperature, top_k, k_max)
    gumbel = -torch.log(-torch.log(_uniforms(keys, counts, logits.shape[-1])))
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def verify_slots_keyed(logits: torch.Tensor, draft: torch.Tensor, draft_len: torch.Tensor,
                       temperature: torch.Tensor, top_k: torch.Tensor, keys: torch.Tensor,
                       counts: torch.Tensor, *, active: torch.Tensor, tokens0: torch.Tensor,
                       positions: torch.Tensor, remaining: torch.Tensor, eos: torch.Tensor,
                       max_len: int, k_max: int = 64) -> dict:
    """The acceptance chain over a verified draft window, unrolled over its
    K + 1 positions, all on the device.

    ``logits[:, i]`` (B, K+1, V) is the model's next-token distribution
    after window input i (input 0 is the slot's last emitted token, inputs
    1..K its draft (B, K), ``draft_len`` (B,) of them valid).  Position 0
    draws exactly as the decode step does (draw ``counts`` of the row's
    stream).  The chain goes on to position i only while every earlier
    draw equalled the draft token fed after it, since only then is row i
    the distribution after the emitted stream.  The emitted token is
    always the model's own draw, never the draft's, so greedy and sampled
    streams equal those without speculation.  Each emitted token advances
    position, budget and draw index once; EOS, the budget or the length
    bound ends the chain inside the window where a decode step would have
    stopped.  ``active`` (B,) bool; ``tokens0``, ``positions``,
    ``remaining``, ``eos`` (B,) int32; ``keys``, ``counts`` (B,) int64.
    Returns the emitted tokens (B, K+1) int32 and emission mask (B, K+1)
    bool (a prefix of the window), ``done`` (B,) bool, and the rows' new
    ``last_token``, ``positions``, ``remaining``, ``counts`` and
    ``active``."""
    cont = active
    tok = tokens0
    done = torch.zeros_like(active)
    done_any = torch.zeros_like(active)
    tok_cols, emit_cols = [], []
    for i in range(logits.shape[1]):
        if i > 0:
            cont = cont & ~done & (i <= draft_len) & (tok == draft[:, i - 1])
        drawn = sample_slots_keyed(logits[:, i], temperature, top_k, keys, counts,
                                   k_max=k_max).to(tok.dtype)
        tok = torch.where(cont, drawn, tok)
        ci = cont.to(positions.dtype)
        positions = positions + ci
        remaining = remaining - ci
        counts = counts + ci
        hit_eos = (eos >= 0) & (tok == eos)
        done = cont & (hit_eos | (remaining <= 0) | (positions >= max_len - 1))
        done_any = done_any | done
        tok_cols.append(tok)
        emit_cols.append(cont)
    return {"tokens": torch.stack(tok_cols, dim=1), "emit": torch.stack(emit_cols, dim=1),
            "done": done_any, "last_token": tok, "positions": positions,
            "remaining": remaining, "counts": counts, "active": active & ~done_any}


def sample(logits: torch.Tensor, params: SamplingParams, key: int,
           index: int = 0) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int64: every row under ``params``,
    draw ``index`` of the stream ``key``."""
    B, dev = logits.shape[0], logits.device
    return sample_slots_keyed(
        logits, torch.full((B,), params.temperature, dtype=torch.float32, device=dev),
        torch.full((B,), params.top_k, dtype=torch.int32, device=dev),
        torch.full((B,), key, dtype=torch.int64, device=dev),
        torch.full((B,), index, dtype=torch.int64, device=dev),
        k_max=max(params.top_k, 1))
