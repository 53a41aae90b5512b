"""Kernel-level timeline profiling (paper §2.5), exported for Perfetto; the
counterpart of ``repro/core/trace.py``.

Two paths, the paper's PyTorch-Profiler→Perfetto flow:

* ``capture_torch_trace`` — wraps ``torch.profiler`` for real-hardware runs
  and exports its chrome trace (Perfetto-loadable).
* ``estimated_timeline`` — op-granular roofline timeline derived from the
  model structure + hardware spec, exported as chrome-trace JSON
  (``ui.perfetto.dev`` opens it directly).  This works on the CPU dev
  container and is also the visual companion of the §Roofline numbers:
  each op event carries its FLOPs, bytes and bound-ness in ``args``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from repro_torch.core.hardware import HardwareSpec, get_hardware
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class OpEvent:
    name: str
    dur_s: float
    flops: float
    bytes_moved: float
    bound: str
    category: str


def _op_time(hw: HardwareSpec, flops: float, bytes_moved: float):
    ct = flops / (hw.peak_flops_bf16 * hw.eta_compute)
    mt = bytes_moved / (hw.hbm_bw * hw.eta_memory)
    return max(ct, mt), ("compute" if ct >= mt else "memory")


def _block_ops(cfg: ModelConfig, kind: str, tokens: int, kv_len: int,
               decode: bool, itemsize: int = 2) -> List[Dict]:
    """Analytic (flops, bytes) per op inside one block."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    ops: List[Dict] = []

    def op(name, flops, bytes_moved, cat):
        ops.append(dict(name=name, flops=flops, bytes=bytes_moved, cat=cat))

    norm_bytes = 2 * tokens * d * itemsize
    if kind in ("attn", "local_attn"):
        wq = d * h * hd
        wkv = 2 * d * kv * hd
        wo = h * hd * d
        op("rmsnorm", 6.0 * tokens * d, norm_bytes, "norm")
        op("qkv_proj", 2.0 * tokens * (wq + wkv),
           (wq + wkv) * itemsize + tokens * d * itemsize, "gemm")
        ctx = min(cfg.sliding_window, kv_len) if kind == "local_attn" and \
            cfg.sliding_window else kv_len
        a_flops = 4.0 * tokens * h * hd * (ctx if decode else ctx / 2)
        # flash-tiled KV traffic: the KV stream is re-read once per q block
        batch = max(tokens // max(kv_len, 1), 1) if not decode else tokens
        q_passes = 1 if decode else max((tokens // batch) // 1024, 1)
        a_bytes = (2 * batch * ctx * kv * hd * itemsize * q_passes
                   + 2 * tokens * h * hd * itemsize)  # + Q read / O write
        op("attention", a_flops, a_bytes, "attn")
        op("out_proj", 2.0 * tokens * wo, wo * itemsize + tokens * d * itemsize, "gemm")
        if cfg.is_moe:
            k = cfg.num_experts_per_tok
            wff = 3 * d * cfg.d_ff
            op("rmsnorm", 6.0 * tokens * d, norm_bytes, "norm")
            op("moe_route", 2.0 * tokens * d * cfg.num_experts,
               tokens * cfg.num_experts * 4, "gemm")
            active_w = wff * min(cfg.num_experts, k * max(tokens, 1)) \
                if decode else wff * cfg.num_experts
            op("moe_experts", 2.0 * tokens * k * wff, active_w * itemsize, "gemm")
            if cfg.num_shared_experts:
                wsh = 3 * d * cfg.d_ff * cfg.num_shared_experts
                op("moe_shared", 2.0 * tokens * wsh, wsh * itemsize, "gemm")
        else:
            wff = (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
            op("rmsnorm", 6.0 * tokens * d, norm_bytes, "norm")
            op("mlp", 2.0 * tokens * wff, wff * itemsize + tokens * d * itemsize, "gemm")
    elif kind == "ffn":
        wff = (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
        op("rmsnorm", 6.0 * tokens * d, norm_bytes, "norm")
        op("mlp", 2.0 * tokens * wff, wff * itemsize + tokens * d * itemsize, "gemm")
    elif kind == "rglru":
        W = cfg.resolved_lru_width
        op("rmsnorm", 6.0 * tokens * d, norm_bytes, "norm")
        op("rglru_proj", 2.0 * tokens * 2 * d * W, 2 * d * W * itemsize, "gemm")
        op("rglru_scan", 10.0 * tokens * W, 3 * tokens * W * 4, "scan")
        op("rglru_out", 2.0 * tokens * W * d, W * d * itemsize, "gemm")
        wff = (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
        op("mlp", 2.0 * tokens * wff, wff * itemsize, "gemm")
    elif kind in ("mlstm", "slstm"):
        W = int(d * cfg.mlstm_proj_factor) if kind == "mlstm" else d
        H = cfg.resolved_rec_heads
        Dh = W // H
        op("rmsnorm", 6.0 * tokens * d, norm_bytes, "norm")
        op(f"{kind}_proj", 2.0 * tokens * (2 * d * W + 3 * W * Dh),
           (2 * d * W + 3 * H * Dh * Dh) * itemsize, "gemm")
        state = H * Dh * Dh * 4
        op(f"{kind}_cell", 8.0 * tokens * H * Dh * Dh / max(1, 1),
           (tokens * W * 4 + 2 * state * (tokens if decode else tokens / 64)), "scan")
        op(f"{kind}_out", 2.0 * tokens * W * d, W * d * itemsize, "gemm")
    return ops


def estimated_timeline(
    cfg: ModelConfig,
    *,
    hardware: str = "h100",
    phase: str = "decode",
    batch: int = 1,
    seq_len: int = 1024,
) -> List[OpEvent]:
    hw = get_hardware(hardware)
    decode = phase == "decode"
    tokens = batch * (1 if decode else seq_len)
    events: List[OpEvent] = []
    emb_bytes = cfg.vocab_size * cfg.d_model * 2
    emb_dur, _ = _op_time(hw, 0, tokens * cfg.d_model * 2)
    events.append(OpEvent("embed", emb_dur, 0, tokens * cfg.d_model * 2,
                          "memory", "gather"))
    for li, kind in enumerate(cfg.blocks()):
        for o in _block_ops(cfg, kind, tokens, seq_len, decode):
            dur, bound = _op_time(hw, o["flops"], o["bytes"])
            events.append(OpEvent(
                f"L{li:02d}/{o['name']}", dur, o["flops"], o["bytes"], bound,
                o["cat"],
            ))
    lm_flops = 2.0 * tokens * cfg.d_model * cfg.vocab_size
    dur, bound = _op_time(hw, lm_flops, emb_bytes)
    events.append(OpEvent("lm_head", dur, lm_flops, emb_bytes, bound, "gemm"))
    return events


def to_chrome_trace(events: List[OpEvent], path: str,
                    meta: Optional[Dict] = None) -> str:
    """Write a Perfetto-loadable chrome-trace JSON; returns the path."""
    trace = {"traceEvents": [], "displayTimeUnit": "ns",
             "metadata": meta or {}}
    ts = 0.0
    for ev in events:
        trace["traceEvents"].append({
            "name": ev.name, "ph": "X", "ts": ts * 1e6, "dur": ev.dur_s * 1e6,
            "pid": 0, "tid": 0, "cat": ev.category,
            "args": {"flops": ev.flops, "bytes": ev.bytes_moved,
                     "bound": ev.bound},
        })
        ts += ev.dur_s
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def timeline_summary(events: List[OpEvent]) -> Dict[str, float]:
    total = sum(e.dur_s for e in events)
    by_cat: Dict[str, float] = {}
    for e in events:
        by_cat[e.category] = by_cat.get(e.category, 0.0) + e.dur_s
    out = {"total_s": total}
    out.update({f"{k}_s": v for k, v in sorted(by_cat.items())})
    out["memory_bound_frac"] = sum(
        e.dur_s for e in events if e.bound == "memory") / max(total, 1e-12)
    return out


def capture_torch_trace(path: str, fn, *args, **kwargs):
    """Real-hardware trace of ``fn(*args, **kwargs)`` via ``torch.profiler``
    (CPU activity, and CUDA activity where there is a GPU), written as
    chrome-trace JSON that Perfetto loads; returns ``fn``'s result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return out
