"""Decode-time caches: the counterpart of the contiguous, ring-buffer,
paged and recurrent-state parts of ``repro/models/cache.py``.

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
max_len)`` entries in both layouts; RG-LRU layers a per-row state ``h``
(fp32) and ``conv`` (the last K-1 inputs); mLSTM layers the matrix memory
``C``, its normalizer ``n`` and stabilizer ``m`` (fp32) and ``conv``;
sLSTM layers ``c``, ``n``, ``m``, ``h`` (fp32) and ``conv``.  All of them
belong to their slot, never to the pool.  A stabilizer ``m`` starts at
-1e30 (``M_INIT``), every other state leaf at 0.

In an encoder-decoder model each attention entry, in both layouts, also
holds the encoder memory's K/V, ``cross_k``/``cross_v`` ``(batch,
max_len // 2, H, D)`` as the reference sizes them, and ``cross_pos``
``(batch, max_len // 2)`` int32: 0 for the rows a prefill filled, -1
past them.  The reference replaces its memory by the prompt's own ``T``
rows; a CUDA graph captured before the prefill cannot follow a change of
shape, so the port writes the first ``T`` rows and masks the rest through
``cross_pos``.  The reference has no such leaf, so the size reports leave
it out (``core/cache.py``).

``BlockPool`` is the host-side bookkeeping of the paged layout: the LIFO
free stack and, for block-level prefix caching, refcounts, a ``hash ->
block`` registry over ``hash_token_blocks`` and an evictable LRU.

Chunked prefill writes a chunk of K/V next to the earlier ones
(``append_attn_cache``, ``append_paged_cache``) and reads the pool back
as dense K/V (``gather_paged_kv``); ``reset_rows`` returns a slot's rows
to their initial values before its first chunk.

A tensor-parallel rank's entries (``init_block_cache(..., shards=)``) hold
its shard of each leaf as the reference's ``cache_shardings`` lays it out
(``sharding.rules.cache_dim``): contiguous K/V its KV heads, or, where tp
does not divide them, its slots ``[r·L/tp, (r+1)·L/tp)`` of every head
(an L-sharded entry, also a sliding-window ring; ``pos`` whole, so the
split shows in the shapes); a pool its heads, or all of them; a
recurrent state its heads or width.  The contiguous writes take the
rank's mesh (``mesh=``) and write only its own slots; ``read_kv`` gathers
the slots of every rank.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import cache_dim, local_shape

GARBAGE_BLOCK = 0  # pool block reserved for idle-slot writes; never allocated
M_INIT = -1e30     # an xLSTM stabilizer's initial value: below every log gate
# the initial value of each leaf that does not start at 0
INIT_FILL = {"pos": -1, "cross_pos": -1, "m": M_INIT}


def blocks_per_slot(max_len: int, block_size: int) -> int:
    """Block-table width needed to address ``max_len`` tokens."""
    return -(-max_len // block_size)


def default_num_blocks(batch: int, max_len: int, block_size: int) -> int:
    """Worst-case pool: every slot full, plus the reserved garbage block."""
    return batch * blocks_per_slot(max_len, block_size) + 1


def suggest_num_blocks(seq_lens, block_size: int, max_len: int, max_batch: int,
                       concurrency: int = 0, q: float = 95.0) -> int:
    """A pool sized for the workload (``--kv-num-blocks auto``) instead of
    the worst case: the ``q``-th percentile of the trace's sequence lengths
    (prompt + budget, at most ``max_len``) for each of ``concurrency``
    live slots (0: ``max_batch``, the saturated case; see
    ``serving.workload.estimate_concurrency``), one slack block per slot
    and the garbage block.  Clamped between one worst-case request plus
    the garbage block (below it a long request could never finish) and
    the worst case.  Such a pool can still run dry on a bursty tail: pair
    it with ``preemption="recompute"``."""
    lens = sorted(min(int(n), max_len) for n in seq_lens)
    if not lens:
        return default_num_blocks(max_batch, max_len, block_size)
    k = max(int(-(-len(lens) * q // 100)), 1) - 1
    p_len = lens[min(k, len(lens) - 1)]
    slots = min(max(int(concurrency) or max_batch, 1), max_batch)
    want = slots * (blocks_per_slot(p_len, block_size) + 1) + 1
    floor = blocks_per_slot(max_len, block_size) + 1
    return min(max(want, floor), default_num_blocks(max_batch, max_len, block_size))


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def hash_token_blocks(tokens, block_size: int) -> List[int]:
    """Chained FNV-1a hash of each *full* ``block_size`` block of
    ``tokens``: ``hashes[i]`` covers ``tokens[:(i + 1) * block_size]``, so
    a match at ``i`` means (up to a collision) the whole prefix matches,
    and with it the K/V of blocks ``0..i``.  A trailing partial block is
    not hashed: it is still being written and is never shared."""
    hashes: List[int] = []
    h = _FNV_OFFSET
    for i in range(len(tokens) // block_size):
        for t in tokens[i * block_size:(i + 1) * block_size]:
            h = ((h ^ (int(t) & _MASK64)) * _FNV_PRIME) & _MASK64
        hashes.append(h)
    return hashes


class BlockPool:
    """Host-side bookkeeping of the paged block pool: a LIFO free stack
    over blocks ``1..num_blocks-1`` (block 0 is the garbage block) and, for
    block-level prefix caching, per-block refcounts, the ``hash -> block``
    registry and an LRU of evictable cached blocks.

    A block's life::

        free stack --allocate--> private (owned by one request)
          private --register--> shared (refcount = live readers)
          shared --lookup hit--> refcount + 1
          shared --freed by its last reader--> evictable LRU (content kept)
          evictable --lookup hit--> shared again
          evictable --pool pressure--> evicted: unregistered, reallocated
          private --freed--> free stack

    A registered block is visible to ``lookup`` only once ``mark_ready``
    says its K/V is written (a chunked prefill registers at admission and
    fills over many steps).
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.free_stack: List[int] = list(range(num_blocks - 1, 0, -1))
        self.refs: Dict[int, int] = {}        # registered block -> live readers
        self.block_of: Dict[int, int] = {}    # prefix hash -> block
        self.hash_of: Dict[int, int] = {}     # block -> prefix hash
        self.ready: set = set()               # registered blocks fully written
        self.evictable: "OrderedDict[int, None]" = OrderedDict()  # LRU first
        self.evictions = 0
        # hash -> [hits, misses, evictions]; ``lookup`` counts hits and
        # misses (``peek`` is a budget probe and counts nothing)
        self.prefix_stats: Dict[int, List[int]] = {}

    def _stat(self, h: int) -> List[int]:
        return self.prefix_stats.setdefault(h, [0, 0, 0])

    @property
    def available(self) -> int:
        """Blocks an admission may claim: free plus evictable."""
        return len(self.free_stack) + len(self.evictable)

    @property
    def in_use(self) -> int:
        """Blocks owned by live requests."""
        return max(self.num_blocks - 1, 0) - self.available

    def shard_accounting(self, n_devices: int) -> List[Dict[str, int]]:
        """Per-device block accounting of a tensor-parallel pool: the pool
        shards the KV heads (or holds every head where tp does not divide
        them), never the block axis, so every device holds its heads of
        every block and the host-managed tables index each device's pool
        alike.  Each device's view is this pool's partition:
        ``free + in_use + evictable`` tiles the allocatable blocks
        ``1..num_blocks-1`` on each shard."""
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        allocatable = max(self.num_blocks - 1, 0)
        free, evictable = len(self.free_stack), len(self.evictable)
        view = {"free": free, "in_use": allocatable - free - evictable,
                "evictable": evictable, "allocatable": allocatable}
        return [dict(view) for _ in range(n_devices)]

    def allocate(self, n: int) -> List[int]:
        """Pop ``n`` blocks, evicting the LRU cached ones when the free
        stack runs dry."""
        if n > self.available:
            raise ValueError(f"allocate({n}) with only {self.available} blocks available")
        return [self.free_stack.pop() if self.free_stack else self._evict_lru()
                for _ in range(n)]

    def _evict_lru(self) -> int:
        blk, _ = self.evictable.popitem(last=False)
        if self.refs.get(blk, 0):
            raise RuntimeError(f"evicting block {blk}, which has live readers")
        h = self.hash_of.get(blk)
        if h is not None:
            self._stat(h)[2] += 1
        self._unregister(blk)
        self.evictions += 1
        return blk

    def _unregister(self, blk: int) -> None:
        h = self.hash_of.pop(blk, None)
        if h is not None:
            del self.block_of[h]
        self.refs.pop(blk, None)
        self.ready.discard(blk)

    def register(self, h: int, blk: int) -> bool:
        """Claim hash ``h`` for ``blk`` (its owner holds one reference; not
        ready yet).  False if ``h`` is registered already: the block then
        stays private."""
        if h in self.block_of:
            return False
        self.block_of[h] = blk
        self.hash_of[blk] = h
        self.refs[blk] = 1
        return True

    def mark_ready(self, blk: int) -> None:
        """Make a registered block's content visible to ``lookup``."""
        if blk in self.hash_of:
            self.ready.add(blk)

    def peek(self, hashes: List[int]) -> int:
        """Leading blocks of ``hashes`` that are registered, ready and
        referenced: a budget estimate that never overstates ``lookup``
        (an evictable block could be evicted before the admission
        commits, so it does not count)."""
        n = 0
        for h in hashes:
            blk = self.block_of.get(h)
            if blk is None or blk not in self.ready or self.refs.get(blk, 0) <= 0:
                break
            n += 1
        return n

    def lookup(self, hashes: List[int]) -> List[int]:
        """The longest ready cached prefix of ``hashes``: takes a reference
        on each matched block (an evictable one leaves the LRU) and returns
        them in prefix order."""
        out: List[int] = []
        for h in hashes:
            blk = self.block_of.get(h)
            if blk is None or blk not in self.ready:
                self._stat(h)[1] += 1  # the first miss ends the usable prefix
                break
            if self.refs[blk] == 0:
                del self.evictable[blk]
            self.refs[blk] += 1
            self._stat(h)[0] += 1
            out.append(blk)
        return out

    def free(self, blocks: List[int]) -> None:
        """Return a request's blocks, last first.  A shared block loses a
        reference; its last reader parks it on the evictable LRU, or
        unregisters it if it never became ready.  A private block goes
        back on the free stack, so the next allocation hands the blocks
        out again in table order.  Parking tail first makes a chain's tail
        the oldest on the LRU: pressure evicts a cached prefix from the
        right, and its head keeps matching."""
        for blk in reversed(blocks):
            if blk in self.hash_of:
                self.refs[blk] -= 1
                if self.refs[blk] < 0:
                    raise RuntimeError(f"double free of block {blk}")
                if self.refs[blk] == 0:
                    if blk in self.ready:
                        self.evictable[blk] = None
                    else:
                        self._unregister(blk)
                        self.free_stack.append(blk)
            else:
                self.free_stack.append(blk)


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


def _first_slot(cache: Dict, mesh) -> int:
    """The first of the L slots (``pos``'s) that this rank's ``k``/``v``
    hold: 0 unless the entry is L-sharded (its ``k`` shorter than ``pos``),
    then the rank's ``mesh.rank``-th slice."""
    n = cache["k"].shape[1]
    return mesh.rank * n if n < cache["pos"].shape[1] else 0


def _put_kv(cache: Dict, slots: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            keep: Optional[torch.Tensor], mesh) -> None:
    """Write ``k``/``v`` (B, C, H, D) at ``slots`` (B, C) of the entry's L,
    distinct within a row where kept: the entries ``keep`` (B, C) bool
    marks (None: all) that land in this rank's slots.  In index form, as
    one write: a dropped entry writes back the value that the row's first
    kept entry writes, at its slot (a row with none, its slot 0's own
    value), so every write to one element carries one value."""
    B, C = slots.shape
    n = cache["k"].shape[1]
    rows = torch.arange(B, device=slots.device)[:, None]
    local = slots - _first_slot(cache, mesh)
    if n < cache["pos"].shape[1]:
        mine = (local >= 0) & (local < n)
        keep = mine if keep is None else keep & mine
    if keep is None:
        cache["k"][rows, local] = k.to(cache["k"].dtype)
        cache["v"][rows, local] = v.to(cache["v"].dtype)
        return
    first = keep.int().argmax(dim=1, keepdim=True)              # (B, 1)
    some = keep.any(dim=1, keepdim=True)
    col = torch.where(keep, torch.arange(C, device=slots.device)[None], first)
    idx = torch.where(keep, local, torch.where(some, local.gather(1, first), 0))
    take = some[..., None, None]
    for leaf, new in (("k", k), ("v", v)):
        t = cache[leaf]
        val = new.gather(1, col[..., None, None].expand_as(new)).to(t.dtype)
        t[rows, idx] = torch.where(take, val, t[rows, idx])


def read_kv(cache: Dict, heads: slice = slice(None), mesh=None):
    """A contiguous entry's K/V of ``heads`` over all its L slots: an
    L-sharded entry's slices gathered over the ranks of ``mesh`` (one
    collective for both) into a transient buffer.  The ranks' queries read
    different KV heads, and an all-gather sends each rank's one buffer to
    every rank, so it carries every KV head the entry holds (their union;
    one for MQA) and the rank keeps its own."""
    k, v = cache["k"], cache["v"]
    if k.shape[1] < cache["pos"].shape[1]:
        kv = mesh.gather(torch.stack([k, v]), 2)
        k, v = kv[0], kv[1]
    return k[:, :, heads].contiguous(), v[:, :, heads].contiguous()


def fill_attn_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, mesh=None) -> Dict:
    """Write a full prefill's K/V (B, S, H, D) into the cache.

    A ring keeps only the last ``L`` timesteps.  ``positions`` is (B, S)
    with identical rows; row 0 gives the slot bookkeeping.  Every slot is
    written (unfilled ones with position -1), so the entry holds this
    prompt only.  An L-sharded entry takes the slots of ``mesh``'s rank.
    """
    B, S = k.shape[:2]
    L = cache["pos"].shape[1]
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
    cache["pos"][:, slots] = p_tail[None, :]
    _put_kv(cache, slots.expand(B, L), k_tail, v_tail, None, mesh)
    return cache


def update_attn_cache(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                      positions: torch.Tensor,
                      update_mask: Optional[torch.Tensor] = None, mesh=None) -> Dict:
    """Write one decoded token's K/V (B, 1, H, D) at per-row ``positions``
    (B,).  ``update_mask`` (B,) bool turns masked-off rows into no-op
    writes (their current cache content is written back); so does a slot
    that is not the rank's in an L-sharded entry."""
    B, L = cache["pos"].shape
    positions = positions.to(torch.int32).expand(B)
    slot = (positions % L).long()
    rows = torch.arange(B, device=slot.device)
    _put_kv(cache, slot[:, None], k_new, v_new,
            None if update_mask is None else update_mask[:, None], mesh)
    p_w = positions
    if update_mask is not None:
        p_w = torch.where(update_mask, p_w, cache["pos"][rows, slot])
    cache["pos"][rows, slot] = p_w
    return cache


def append_attn_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor,
                      valid: Optional[torch.Tensor] = None, mesh=None) -> Dict:
    """Write a prompt chunk's K/V (B, C, H, D) at absolute ``positions``
    (B, C) into a contiguous or ring cache, next to the entries already
    there.  A chunk longer than a ring keeps its tail.

    ``valid`` (B, C) bool makes masked-off entries no-op writes (the
    current content is written back): the unified step packs ragged
    chunks into one static width, and pad columns must not clobber live
    entries.  With ``valid`` and C > L each row keeps its last <= L
    *valid* entries.  An L-sharded entry takes only the slots of
    ``mesh``'s rank."""
    B, C = k.shape[:2]
    L = cache["pos"].shape[1]
    positions = positions.to(torch.int32)
    if C > L and valid is None:
        k, v, positions = k[:, C - L:], v[:, C - L:], positions[:, C - L:]
    elif C > L:
        # ragged rows: gather each row's window of L columns ending at its
        # last valid one; positions are consecutive within a row, so they
        # are recomputed, which keeps the L slots distinct where the
        # gather index saturates at C - 1 (those entries are invalid)
        n = valid.sum(dim=1, dtype=torch.int32)
        base = (n - L).clamp_min(0)
        idx = base[:, None] + torch.arange(L, dtype=torch.int32, device=k.device)[None]
        gat = idx.clamp_max(C - 1).long()[..., None, None].expand(-1, -1, *k.shape[2:])
        k, v = torch.gather(k, 1, gat), torch.gather(v, 1, gat)
        positions = positions[:, :1] + idx
        valid = idx < n[:, None]
    rows = torch.arange(B, device=k.device)[:, None]
    slots = (positions % L).long()
    _put_kv(cache, slots, k, v, valid, mesh)
    if valid is not None:  # a row's C <= L slots are distinct: writing back is a no-op
        positions = torch.where(valid, positions, cache["pos"][rows, slots])
    cache["pos"][rows, slots] = positions
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


def append_paged_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, block_tables: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> Dict:
    """Write a prompt chunk's K/V (B, C, H, D) at absolute ``positions``
    (B, C) through the block tables: position ``p`` of row ``b`` lands at
    ``pool[table[b, p // bs], p % bs]``, so a chunk may start and end
    anywhere inside a block.  ``valid`` (B, C) bool routes masked-off
    entries to the garbage block (a pad column's position may lie past
    the row's blocks, or the whole row may be idle)."""
    bs = cache["kp"].shape[1]
    positions = positions.to(torch.int32)
    idx = positions // bs
    if valid is not None:  # pad positions can run past the table
        idx = idx.clamp(0, block_tables.shape[1] - 1)
    blk = torch.gather(block_tables, 1, idx.long())
    if valid is not None:
        blk = torch.where(valid, blk, GARBAGE_BLOCK)
    blk, off = blk.long(), (positions % bs).long()
    cache["kp"][blk, off] = k.to(cache["kp"].dtype)
    cache["vp"][blk, off] = v.to(cache["vp"].dtype)
    return cache


def gather_paged_kv(cache: Dict, block_tables: torch.Tensor):
    """Each row's pool blocks as dense K/V plus key positions: ``(k, v,
    k_positions)`` of shapes (B, M*bs, H, D) twice and (B, M*bs), M the
    table width.  Gathered index ``j`` is absolute position ``j``; table
    entries past a row's blocks point at the garbage block, at positions
    past every query, which causal masking hides.  The chunked prefill
    attends over this; decode reads the pool through the table (K4)."""
    kp, vp = cache["kp"], cache["vp"]
    B, M = block_tables.shape
    bs = kp.shape[1]
    idx = block_tables.long()
    k = kp[idx].reshape(B, M * bs, *kp.shape[2:])
    v = vp[idx].reshape(B, M * bs, *vp.shape[2:])
    pos = torch.arange(M * bs, dtype=torch.int32, device=kp.device).expand(B, M * bs)
    return k, v, pos.contiguous()


def init_cross_cache(batch: int, max_len: int, n_kv: int, head_dim: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    """An encoder-decoder attention entry's memory leaves: ``max_len // 2``
    rows (1 at ``max_len`` 1), as the reference's ``init_cache`` sizes
    them, none filled."""
    t_mem = max_len // 2 if max_len > 1 else 1
    return {
        "cross_k": torch.zeros((batch, t_mem, n_kv, head_dim), dtype=dtype, device=device),
        "cross_v": torch.zeros((batch, t_mem, n_kv, head_dim), dtype=dtype, device=device),
        "cross_pos": torch.full((batch, t_mem), -1, dtype=torch.int32, device=device),
    }


def fill_cross_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor) -> Dict:
    """Write the encoder memory's K/V (B, T, H, D) into the first T rows
    of the entry's ``cross_k``/``cross_v`` and mark them valid, the rows
    past T invalid, in place."""
    T, rows = k.shape[1], cache["cross_pos"].shape[1]
    if T > rows:
        raise ValueError(f"an encoder memory of {T} rows does not fit the cache's {rows} "
                         f"(max_len // 2 of the cache)")
    cache["cross_k"][:, :T] = k.to(cache["cross_k"].dtype)
    cache["cross_v"][:, :T] = v.to(cache["cross_v"].dtype)
    cache["cross_pos"][:, :T] = 0
    cache["cross_pos"][:, T:] = -1
    return cache


def init_rglru_state(batch: int, width: int, conv_width: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype, device=device),
    }


def init_mlstm_state(batch: int, heads: int, dk: int, dv: int, conv_width: int,
                     dtype, device) -> Dict[str, torch.Tensor]:
    st = {
        "C": torch.zeros((batch, heads, dk, dv), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, heads, dk), dtype=torch.float32, device=device),
        "m": torch.full((batch, heads), M_INIT, dtype=torch.float32, device=device),
    }
    if conv_width > 0:
        st["conv"] = torch.zeros((batch, conv_width - 1, heads * dv), dtype=dtype,
                                 device=device)
    return st


def init_slstm_state(batch: int, heads: int, dh: int, conv_width: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, heads, dh), **f32),
        "n": torch.zeros((batch, heads, dh), **f32),
        "m": torch.full((batch, heads, dh), M_INIT, **f32),
        "h": torch.zeros((batch, heads, dh), **f32),
        "conv": torch.zeros((batch, conv_width - 1, heads * dh), dtype=dtype, device=device),
    }


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, *, layout: str = "contiguous",
                     block_size: int = 16, num_blocks: int = 0,
                     shards: int = 1) -> Dict[str, torch.Tensor]:
    """One layer's cache entry.  ``layout="paged"`` gives full-context
    attention a block pool of ``num_blocks`` x ``block_size`` tokens (0:
    the worst case for ``batch`` rows of ``max_len``); rings and recurrent
    states are the same in both layouts.  The entry of one of ``shards``
    tensor-parallel ranks: each leaf cut along the dim
    ``sharding.rules.cache_dim`` gives it (whole at one shard), at its
    initial value (``INIT_FILL``; a ring's length is its window, below
    ``max_len``)."""
    full = _block_cache(cfg, kind, batch, max_len, dtype, "meta", layout=layout,
                        block_size=block_size, num_blocks=num_blocks)
    fill = dict(INIT_FILL, ring=int("pos" in full and full["pos"].shape[1] < max_len))
    return {leaf: torch.full(local_shape(t.shape, cache_dim(leaf, t.shape, shards), shards),
                             fill.get(leaf, 0), dtype=t.dtype, device=device)
            for leaf, t in full.items()}


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype, device, *,
                 layout: str, block_size: int, num_blocks: int) -> Dict[str, torch.Tensor]:
    hd = cfg.resolved_head_dim
    if kind == "ffn":
        return {}
    if kind in ("attn", "local_attn"):
        if kind == "attn" and layout == "paged":
            n = num_blocks or default_num_blocks(batch, max_len, block_size)
            entry = init_paged_attn_cache(n, block_size, cfg.num_kv_heads, hd, dtype, device)
        else:
            entry = init_attn_cache(batch, max_len, cfg.num_kv_heads, hd, dtype, device,
                                    window=cfg.sliding_window if kind == "local_attn" else 0)
        if cfg.is_encdec:
            entry.update(init_cross_cache(batch, max_len, cfg.num_kv_heads, hd, dtype,
                                          device))
        return entry
    if kind == "rglru":
        return init_rglru_state(batch, cfg.resolved_lru_width, cfg.rglru_conv_width,
                                dtype, device)
    if kind == "mlstm":
        w = int(cfg.d_model * cfg.mlstm_proj_factor)
        h = cfg.resolved_rec_heads
        return init_mlstm_state(batch, h, w // h, w // h, cfg.rglru_conv_width, dtype, device)
    if kind == "slstm":
        h = cfg.resolved_rec_heads
        return init_slstm_state(batch, h, cfg.d_model // h, cfg.rglru_conv_width, dtype,
                                device)
    raise ValueError(f"no cache for block kind {kind!r}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device, *,
               layout: str = "contiguous", block_size: int = 16,
               num_blocks: int = 0, shards: int = 1) -> List[Dict[str, torch.Tensor]]:
    """One ``init_block_cache`` entry per layer of ``cfg`` (a rank's of
    ``shards``)."""
    if layout not in ("contiguous", "paged"):
        raise ValueError(f"layout {layout!r} is not 'contiguous' or 'paged'")
    return [init_block_cache(cfg, kind, batch, max_len, dtype, device, layout=layout,
                             block_size=block_size, num_blocks=num_blocks, shards=shards)
            for kind in cfg.blocks()]


def reset_cache(cache: List[Dict[str, torch.Tensor]]) -> List[Dict[str, torch.Tensor]]:
    """Return every entry to what ``init_block_cache`` makes, in place:
    each leaf to its initial value (``INIT_FILL``: positions -1,
    stabilizers -1e30; K/V and the other states 0); the ring flag follows
    from shapes and stays.  A CUDA graph reads the tensors it captured, so
    a captured step's cache is reset, never replaced."""
    for entry in cache:
        for leaf, t in entry.items():
            if leaf != "ring":
                t.fill_(INIT_FILL.get(leaf, 0))
    return cache


def reset_rows(cache: List[Dict[str, torch.Tensor]], rows: torch.Tensor) -> None:
    """Return rows ``rows`` (int64 indices) of every per-slot leaf to what
    ``init_block_cache`` makes, in place (``INIT_FILL``).  Pools belong to
    no row and are left alone, as is the ring flag.  A chunk writes only
    its own span, so a slot's rows are reset before its first chunk."""
    for entry in cache:
        for leaf, t in entry.items():
            if leaf in ("kp", "vp") or t.dim() == 0:
                continue
            t.index_fill_(0, rows, INIT_FILL.get(leaf, 0))


def cache_bytes(cache: List[Dict[str, torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for entry in cache for t in entry.values())
