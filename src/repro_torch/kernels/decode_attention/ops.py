"""Wrapper of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  Inference only.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref

HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
MAX_GROUP = 16  # query heads per KV head the kernel takes
_FN = {torch.bfloat16: "decode_attention_bf16", torch.float32: "decode_attention_f32"}


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
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{Hq // Hkv} query heads per KV head; the kernel takes "
                         f"at most {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if tuple(q_positions.shape) != (B, 1) or tuple(k_positions.shape) != (B, L):
        raise ValueError("positions must be (B, 1) and (B, L)")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the cache must start on a 16-byte boundary (16-byte loads)")


def decode_attention(q, k_cache, v_cache, *, q_positions, k_positions,
                     window=0, softcap=0.0):
    if not q.is_cuda:
        return ref.decode_attention(q, k_cache, v_cache, q_positions=q_positions,
                                    k_positions=k_positions, window=window,
                                    softcap=softcap)
    _check(q, k_cache, v_cache, q_positions, k_positions)
    B, _, Hq, D = q.shape
    L, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    launcher = _build.load()[_FN[q.dtype]]
    status = launcher(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        q_positions.data_ptr(), k_positions.data_ptr(), out.data_ptr(),
        B, L, Hkv, Hq // Hkv, D, int(window), float(softcap), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {status}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
