"""Wrappers of the CUDA decode-attention kernels: contiguous caches
(``csrc/decode_attention.cu``) and the paged block pool
(``csrc/paged_decode_attention.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  Each wrapper launches on the current stream and
never synchronises, so a CUDA graph can capture it.  Inference only.

Both kernels split the keys into chunks across blocks and merge their
partials in a second pass (split-KV): one call is two kernel launches when
there is more than one chunk, and counts as one launch of the wrapper.
``split_plan`` picks the chunks from the shapes alone, never from the
positions, so a captured call replays right as they advance.  What bounds
both is then the few tiles each block loads in turn, one memory round
trip each, and the merge's launch (times in PERF.md).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref

HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
MAX_GROUP = 16  # query heads per KV head the kernel takes
TILE = 64       # keys per staged tile; a chunk is a whole number of tiles
BLOCKS_PER_SM = 2  # pass-1 blocks per SM the split aims for (both kernels)
_FN = {torch.bfloat16: "decode_attention_bf16", torch.float32: "decode_attention_f32"}
_PAGED_FN = {torch.bfloat16: "paged_decode_attention_bf16",
             torch.float32: "paged_decode_attention_f32"}


def _check(q, k_cache, v_cache, q_positions, k_positions):
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "q_positions": q_positions, "k_positions": k_positions}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _FN or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q and the cache must share one dtype of {list(_FN)}, "
                        f"got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"want q (B,1,Hq,D), cache (B,L,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, _, Hq, D = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k_cache.shape)} "
                         f"do not form a GQA pair")
    _check_heads(Hq, Hkv, D)
    if tuple(q_positions.shape) != (B, 1) or tuple(k_positions.shape) != (B, L):
        raise ValueError("positions must be (B, 1) and (B, L)")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the cache must start on a 16-byte boundary (16-byte loads)")


def _check_heads(Hq, Hkv, D):
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq // Hkv} query heads per KV head; the kernel takes "
                         f"at most {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")


def _check_paged(q, k_pool, v_pool, block_tables, q_positions, heads):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "q_positions": q_positions}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _PAGED_FN or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"q and the pool must share one dtype of {list(_PAGED_FN)}, "
                        f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or q_positions.dtype != torch.int32:
        raise TypeError("block tables and positions must be int32")
    if q.dim() != 4 or q.shape[1] != 1 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q (B,1,Hq,D), pools (N,bs,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}")
    B, _, Hq, D = q.shape
    N, bs = k_pool.shape[:2]
    Hkv = heads.stop - heads.start  # the pool heads the call reads
    if N == 0 or bs == 0 or k_pool.shape[3] != D or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and pool {tuple(k_pool.shape)} "
                         f"do not form a GQA pair")
    _check_heads(Hq, Hkv, D)
    if block_tables.dim() != 2 or block_tables.shape[0] != B or block_tables.shape[1] == 0:
        raise ValueError(f"block tables must be (B, nb) with B={B}, got "
                         f"{tuple(block_tables.shape)}")
    if tuple(q_positions.shape) != (B, 1):
        raise ValueError("q_positions must be (B, 1)")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must start on a 16-byte boundary (16-byte loads)")


def split_plan(B: int, Hkv: int, L: int, sms: int) -> tuple[int, int]:
    """``(n_split, chunk)``: the L key slots cut into n_split chunks of
    ``chunk`` slots (a whole number of tiles, the last one ragged) so that
    the B * Hkv * n_split blocks of pass 1 are about ``BLOCKS_PER_SM`` per
    SM, and no chunk is empty.  Shapes only, so a captured call stays
    right as positions advance."""
    tiles = -(-L // TILE)
    want = min(tiles, max(1, -(-BLOCKS_PER_SM * sms // (B * Hkv))))
    per = -(-tiles // want)
    return -(-tiles // per), per * TILE


def check_plan(L: int, n_split: int, chunk: int) -> None:
    """Raise ``ValueError`` unless n_split chunks of ``chunk`` slots, each
    a whole number of tiles, cover the L slots with none empty: what the
    C entry points check again before they launch."""
    if (L < 1 or n_split < 1 or chunk < 1 or chunk % TILE
            or chunk * (n_split - 1) >= L or chunk * n_split < L):
        raise ValueError(f"{n_split} chunks of {chunk} slots do not tile {L} slots "
                         f"in whole {TILE}-key tiles")


def _partials(q, n_parts: int, D: int, n_split: int):
    """Pointers to pass 1's fp32 scratch, m and l (``n_parts`` floats
    each) and acc (``n_parts * D``), and the tensors that hold them; null
    pointers when there is one chunk, which writes the output itself."""
    if n_split == 1:
        return [0, 0, 0], ()
    stats = torch.empty(2, n_parts, device=q.device, dtype=torch.float32)
    acc = torch.empty(n_parts * D, device=q.device, dtype=torch.float32)
    return [stats[0].data_ptr(), stats[1].data_ptr(), acc.data_ptr()], (stats, acc)


def workspace_bytes(B: int, Hq: int, Hkv: int, L: int, D: int, sms: int) -> int:
    """The fp32 scratch a call allocates for pass 1 of its split (``_partials``):
    m, l and acc of every (row, KV head, chunk, query head of the group);
    0 for one chunk, which writes the output itself."""
    n_split, _ = split_plan(B, Hkv, L, sms)
    return 0 if n_split == 1 else 4 * (2 + D) * B * Hq * n_split


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k_cache, v_cache, *, q_positions, k_positions,
                     window=0, softcap=0.0):
    if not q.is_cuda:
        return ref.decode_attention(q, k_cache, v_cache, q_positions=q_positions,
                                    k_positions=k_positions, window=window,
                                    softcap=softcap)
    _check(q, k_cache, v_cache, q_positions, k_positions)
    B, _, Hq, D = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    n_split, chunk = split_plan(B, Hkv, L, _sm_count(q.device.index or 0))
    check_plan(L, n_split, chunk)
    out = torch.empty_like(q)
    scratch, _keep = _partials(q, B * Hkv * n_split * G, D, n_split)
    launcher = _build.load()[_FN[q.dtype]]
    status = launcher(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        q_positions.data_ptr(), k_positions.data_ptr(), out.data_ptr(), *scratch,
        B, L, Hkv, G, D, chunk, n_split, int(window), float(softcap), 1.0 / math.sqrt(D),
        _build.stream(q))
    if status != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {status}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_decode_attention(q, k_pool, v_pool, *, block_tables, q_positions,
                           window=0, softcap=0.0, q_head0=0, group=0):
    """Attention of one query token per row over the block pool, key j of
    row b at ``pool[block_tables[b, j // bs], j % bs]``, split-KV over the
    table's nb * bs positions as ``decode_attention`` is over the cache.
    Query head h reads pool head ``(q_head0 + h) // group`` (``group`` 0:
    Hq / Hkv): whole groups of pool heads, or one group holding every
    query head of the call (``ref.pool_heads``), read in place.  Table
    entries must name blocks of the pool: the kernel reads through them
    unchecked (checking would need the tables on the host)."""
    heads = ref.pool_heads(q.shape[2], k_pool.shape[2], q_head0, group)
    if not q.is_cuda:
        return ref.paged_decode_attention(q, k_pool, v_pool, block_tables=block_tables,
                                          q_positions=q_positions, window=window,
                                          softcap=softcap, q_head0=q_head0, group=group)
    _check_paged(q, k_pool, v_pool, block_tables, q_positions, heads)
    B, _, Hq, D = q.shape
    bs, pool_heads = k_pool.shape[1], k_pool.shape[2]
    Hkv = heads.stop - heads.start
    nb, G = block_tables.shape[1], Hq // Hkv
    n_split, chunk = split_plan(B, Hkv, nb * bs, _sm_count(q.device.index or 0))
    check_plan(nb * bs, n_split, chunk)
    out = torch.empty_like(q)
    scratch, _keep = _partials(q, B * Hkv * n_split * G, D, n_split)
    launcher = _build.load()[_PAGED_FN[q.dtype]]
    status = launcher(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        q_positions.data_ptr(), out.data_ptr(), *scratch, B, nb, bs, Hkv, pool_heads,
        heads.start, G, D, chunk, n_split, int(window), float(softcap), 1.0 / math.sqrt(D),
        _build.stream(q))
    if status != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {status}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
