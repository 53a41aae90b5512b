"""Decode-time caches: the counterpart of the contiguous, ring-buffer,
paged and RG-LRU parts of ``repro/models/cache.py``.

Two layouts for full-context attention KV, with the reference's leaves so
the byte counts of the two packages agree:

* **contiguous** — a layer's entry holds ``k``/``v`` ``(batch, L, H, D)``,
  ``pos`` ``(batch, L)`` int32 absolute key positions (-1 = unfilled) and
  ``ring`` (a 0-d int32 flag, 1 when the entry is a sliding-window ring
  shorter than the context).
* **paged** — a layer's entry holds a global block pool ``kp``/``vp``
  ``(num_blocks, block_size, H, D)`` shared by every slot and addressed
  through an int32 block table ``(batch, blocks_per_slot)``: the token at
  absolute position ``p`` of row ``b`` lives at
  ``pool[table[b, p // bs], p % bs]``.  Block 0 is the reserved garbage
  block: idle rows keep writing their frozen token there and freed rows
  point their whole table row back at it.

Unlike the reference's pure functions, the fill and update functions
write into the entry in place and return it: a decode step then moves one
token's K/V instead of copying the whole cache, and the tensors a CUDA
graph captured stay the ones the next admission fills.

Sliding-window (``local_attn``) layers keep a ring of ``min(window,
max_len)`` entries in both layouts, and RG-LRU layers a per-row state
``h`` (fp32) and ``conv`` (the last K-1 inputs); both belong to their slot,
never to the pool.

``BlockPool`` is the host-side bookkeeping of the paged layout (the LIFO
free stack).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

GARBAGE_BLOCK = 0  # pool block reserved for idle-slot writes; never allocated


def blocks_per_slot(max_len: int, block_size: int) -> int:
    """Block-table width needed to address ``max_len`` tokens."""
    return -(-max_len // block_size)


def default_num_blocks(batch: int, max_len: int, block_size: int) -> int:
    """Worst-case pool: every slot full, plus the reserved garbage block."""
    return batch * blocks_per_slot(max_len, block_size) + 1


class BlockPool:
    """Host-side bookkeeping of the paged block pool: a LIFO free stack over
    blocks ``1..num_blocks-1`` (block 0 is the garbage block).  A block is
    either on the stack or owned by one live request."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.free_stack: List[int] = list(range(num_blocks - 1, 0, -1))

    @property
    def available(self) -> int:
        """Blocks an admission may claim."""
        return len(self.free_stack)

    @property
    def in_use(self) -> int:
        """Blocks owned by live requests."""
        return max(self.num_blocks - 1, 0) - self.available

    def allocate(self, n: int) -> List[int]:
        if n > self.available:
            raise ValueError(f"allocate({n}) with only {self.available} blocks available")
        return [self.free_stack.pop() for _ in range(n)]

    def free(self, blocks: List[int]) -> None:
        """Return a request's blocks, last first, so the next allocation
        hands them out again in table order."""
        self.free_stack.extend(reversed(blocks))


def init_attn_cache(batch: int, max_len: int, n_kv: int, head_dim: int, dtype,
                    device, window: int = 0) -> Dict[str, torch.Tensor]:
    length = min(window, max_len) if window > 0 else max_len
    ring = 1 if (0 < window < max_len) else 0
    return {
        "k": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
        "ring": torch.full((), ring, dtype=torch.int32, device=device),
    }


def fill_attn_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor) -> Dict:
    """Write a full prefill's K/V (B, S, H, D) into the cache.

    A ring keeps only the last ``L`` timesteps.  ``positions`` is (B, S)
    with identical rows; row 0 gives the slot bookkeeping.  Every slot is
    written (unfilled ones with position -1), so the entry holds this
    prompt only.
    """
    S = k.shape[1]
    L = cache["k"].shape[1]
    pos_row = positions[0].to(torch.int32)
    if S >= L:
        k_tail, v_tail, p_tail = k[:, S - L:], v[:, S - L:], pos_row[S - L:]
    else:
        pad = L - S
        k_tail = F.pad(k, (0, 0, 0, 0, 0, pad))
        v_tail = F.pad(v, (0, 0, 0, 0, 0, pad))
        p_tail = F.pad(pos_row, (0, pad), value=-1)
    slots = torch.where(p_tail >= 0, p_tail % L,
                        torch.arange(L, device=p_tail.device) % L).long()
    cache["k"][:, slots] = k_tail.to(cache["k"].dtype)
    cache["v"][:, slots] = v_tail.to(cache["v"].dtype)
    cache["pos"][:, slots] = p_tail[None, :]
    return cache


def update_attn_cache(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                      positions: torch.Tensor,
                      update_mask: Optional[torch.Tensor] = None) -> Dict:
    """Write one decoded token's K/V (B, 1, H, D) at per-row ``positions``
    (B,).  ``update_mask`` (B,) bool turns masked-off rows into no-op
    writes (their current cache content is written back)."""
    B, L = cache["pos"].shape
    positions = positions.to(torch.int32).expand(B)
    slot = (positions % L).long()
    rows = torch.arange(B, device=slot.device)
    k_w, v_w, p_w = k_new[:, 0], v_new[:, 0], positions
    if update_mask is not None:
        m = update_mask.reshape(B, 1, 1)
        k_w = torch.where(m, k_w, cache["k"][rows, slot])
        v_w = torch.where(m, v_w, cache["v"][rows, slot])
        p_w = torch.where(update_mask, p_w, cache["pos"][rows, slot])
    cache["k"][rows, slot] = k_w.to(cache["k"].dtype)
    cache["v"][rows, slot] = v_w.to(cache["v"].dtype)
    cache["pos"][rows, slot] = p_w
    return cache


def init_paged_attn_cache(num_blocks: int, block_size: int, n_kv: int, head_dim: int,
                          dtype, device) -> Dict[str, torch.Tensor]:
    shape = (num_blocks, block_size, n_kv, head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def fill_paged_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                     block_tables: torch.Tensor) -> Dict:
    """Write a full prefill's K/V (B, S, H, D) into pool blocks.

    The prompt occupies absolute positions 0..S-1, so row ``b`` fills table
    entries ``0..ceil(S/bs)-1`` of ``block_tables[b]`` in order.  S is
    padded up to whole blocks with zeros, as the reference does, so the
    pool holds the same bytes block for block; the pad lands at positions
    >= S, which causal masking hides.
    """
    B, S = k.shape[:2]
    bs = cache["kp"].shape[1]
    nb = blocks_per_slot(S, bs)
    pad = nb * bs - S
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    idx = block_tables[:, :nb].reshape(-1).long()
    cache["kp"][idx] = k.reshape(B * nb, bs, *k.shape[2:]).to(cache["kp"].dtype)
    cache["vp"][idx] = v.reshape(B * nb, bs, *v.shape[2:]).to(cache["vp"].dtype)
    return cache


def update_paged_cache(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                       positions: torch.Tensor, block_tables: torch.Tensor,
                       update_mask: Optional[torch.Tensor] = None) -> Dict:
    """Write one decoded token's K/V (B, 1, H, D) at per-row ``positions``
    (B,) through the block tables.  ``update_mask`` (B,) bool routes
    masked-off rows to the garbage block whatever their table row says."""
    B = block_tables.shape[0]
    positions = positions.to(torch.int32).expand(B)
    bs = cache["kp"].shape[1]
    rows = torch.arange(B, device=positions.device)
    blk = block_tables[rows, (positions // bs).long()]
    if update_mask is not None:
        blk = torch.where(update_mask, blk, GARBAGE_BLOCK)
    blk, off = blk.long(), (positions % bs).long()
    cache["kp"][blk, off] = k_new[:, 0].to(cache["kp"].dtype)
    cache["vp"][blk, off] = v_new[:, 0].to(cache["vp"].dtype)
    return cache


def init_rglru_state(batch: int, width: int, conv_width: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype, device=device),
    }


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, *, layout: str = "contiguous",
                     block_size: int = 16, num_blocks: int = 0) -> Dict[str, torch.Tensor]:
    """One layer's cache entry.  ``layout="paged"`` gives full-context
    attention a block pool of ``num_blocks`` x ``block_size`` tokens (0:
    the worst case for ``batch`` rows of ``max_len``); rings and recurrent
    states are the same in both layouts."""
    hd = cfg.resolved_head_dim
    if kind == "ffn":
        return {}
    if kind == "attn":
        if layout == "paged":
            n = num_blocks or default_num_blocks(batch, max_len, block_size)
            return init_paged_attn_cache(n, block_size, cfg.num_kv_heads, hd, dtype, device)
        return init_attn_cache(batch, max_len, cfg.num_kv_heads, hd, dtype, device)
    if kind == "local_attn":
        return init_attn_cache(batch, max_len, cfg.num_kv_heads, hd, dtype, device,
                               window=cfg.sliding_window)
    if kind == "rglru":
        return init_rglru_state(batch, cfg.resolved_lru_width, cfg.rglru_conv_width,
                                dtype, device)
    raise NotImplementedError(f"no cache for block kind {kind!r} in the port yet")


def reset_cache(cache: List[Dict[str, torch.Tensor]]) -> List[Dict[str, torch.Tensor]]:
    """Return every entry to what ``init_block_cache`` makes, in place:
    positions -1, K/V and recurrent states zero (the ring flag follows from
    shapes and stays).  A CUDA graph reads the tensors it captured, so a
    captured step's cache is reset, never replaced."""
    for entry in cache:
        for leaf, t in entry.items():
            if leaf == "pos":
                t.fill_(-1)
            elif leaf != "ring":
                t.zero_()
    return cache


def cache_bytes(cache: List[Dict[str, torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for entry in cache for t in entry.values())
