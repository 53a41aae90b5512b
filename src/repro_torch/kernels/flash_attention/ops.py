"""Wrapper of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

A CUDA tensor launches a kernel or raises; a CPU tensor takes the plain
version in ``ref.py``.  The dtype picks the kernel: bf16 runs on the
tensor cores, fp32 on FMAs (tensor-core products cannot hold fp32 to its
tolerance).  Forward only, as on the reference's prefill path.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
_FN = {torch.bfloat16: "flash_attention_bf16", torch.float32: "flash_attention_f32"}


def _check(q, k, v, q_positions, k_positions):
    tensors = {"q": q, "k": k, "v": v, "q_positions": q_positions,
               "k_positions": k_positions}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {list(_FN)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q_positions.dtype != torch.int32 or k_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,Hq,D), k/v (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"form a GQA pair")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if tuple(q_positions.shape) != (B, S) or tuple(k_positions.shape) != (B, T):
        raise ValueError("positions must be (B, S) and (B, T)")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k and v must start on a 16-byte boundary (16-byte loads)")


def flash_attention(q, k, v, *, q_positions, k_positions, causal, window=0,
                    softcap=0.0):
    if not q.is_cuda:
        return ref.attention(q, k, v, q_positions=q_positions,
                             k_positions=k_positions, causal=causal,
                             window=window, softcap=softcap)
    _check(q, k, v, q_positions, k_positions)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    launcher = _build.load()[_FN[q.dtype]]
    status = launcher(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        k_positions.data_ptr(), out.data_ptr(), B, S, T, Hq, Hkv, D,
        int(causal), int(window), float(softcap), 1.0 / math.sqrt(D),
        _build.stream(q))
    if status != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {status}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
