"""Analytic (estimator-mode) latency + energy model, the counterpart of
``repro/core/estimator.py``: the same model over the port's own size and
cache profilers and hardware registry, so the two agree on every spec both
registries hold.

The paper's Tables 3-4 are reproduced with a roofline-style analytic model
over the hardware registry:

    t_phase = max(FLOPs / (chips · peak · η_c),  bytes / (chips · bw · η_m),
                  collective_bytes / (links · link_bw · η_l)) + overhead

Workload terms (FLOPs / bytes per phase) are derived from the model config +
the *real* size/cache profilers, so MoE activation fractions, sliding-window
caps, and recurrent state sizes are all accounted.

Energy follows the paper's method in model form: average power over the
phase window × latency.  Power = idle + (tdp−idle)·η_p·u, where the
utilization ``u`` depends on platform kind:

* server GPU: u = 1 when any roofline term saturates (boards pull
  near-TDP whether compute- or bandwidth-bound; calibrated η_p=0.91 against
  the paper's A6000 rows, which show ~275 W for both phases),
* edge (Jetson): the paper reads the GPU *rail*, which barely sees DRAM
  power → u = 0.7·compute_frac + 0.3·memory_frac (calibrated on Table 4).

Multi-device modes:
* ``tp``        — tensor parallel: FLOPs/bytes ÷ n, 2 all-reduces/layer.
* ``dp``        — data parallel inference: batch ÷ n, no collectives.
* ``naive_pp``  — HF accelerate-style sequential layer placement (what the
  paper's multi-GPU rows exhibit: one GPU busy at a time, others idle).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core import cache as cache_prof
from repro_torch.core import size as size_prof
from repro_torch.core.hardware import HardwareSpec, get_hardware
from repro_torch.models.config import ModelConfig

ETA_POWER = 0.91  # calibrated on paper Table 3 (A6000 ~275 W @ 300 W TDP)


@dataclasses.dataclass
class PhaseEstimate:
    name: str
    latency_s: float
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    avg_watts: float
    joules: float
    flops: float
    bytes_moved: float


@dataclasses.dataclass
class WorkloadEstimate:
    arch: str
    hardware: str
    n_devices: int
    mode: str
    batch: int
    prompt_len: int
    gen_len: int
    ttft: PhaseEstimate
    tpot: PhaseEstimate
    ttlt: PhaseEstimate

    def row(self) -> Dict[str, float]:
        return {
            "arch": self.arch, "hw": self.hardware, "n_dev": self.n_devices,
            "mode": self.mode, "bsize": self.batch,
            "L": f"{self.prompt_len}+{self.gen_len}",
            "TTFT_ms": self.ttft.latency_s * 1e3,
            "J_per_prompt": self.ttft.joules,
            "TPOT_ms": self.tpot.latency_s * 1e3,
            "J_per_token": self.tpot.joules,
            "TTLT_ms": self.ttlt.latency_s * 1e3,
            "J_per_request": self.ttlt.joules,
        }


# ---------------------------------------------------------------------------
# analytic workload terms
# ---------------------------------------------------------------------------

def _attn_layers(cfg: ModelConfig):
    return [k for k in cfg.blocks() if k in ("attn", "local_attn")]


def attention_flops_prefill(cfg: ModelConfig, batch: int, seq: int) -> float:
    """QK^T + PV flops over the causal prefill, per full forward."""
    hd = cfg.resolved_head_dim
    total = 0.0
    for kind in _attn_layers(cfg):
        if kind == "local_attn" and cfg.sliding_window:
            ctx = min(cfg.sliding_window, seq)
            pairs = seq * ctx - ctx * (ctx - 1) / 2 if seq >= ctx else seq * (seq + 1) / 2
        else:
            pairs = seq * (seq + 1) / 2
        total += 4.0 * batch * cfg.num_heads * hd * pairs
    if cfg.is_encdec:
        enc = seq // 2
        total += 4.0 * batch * cfg.num_heads * hd * enc * enc * cfg.num_encoder_layers
        total += 4.0 * batch * cfg.num_heads * hd * seq * enc * len(_attn_layers(cfg))
    return total


def attention_flops_decode(cfg: ModelConfig, batch: int, kv_len: int) -> float:
    hd = cfg.resolved_head_dim
    total = 0.0
    for kind in _attn_layers(cfg):
        ctx = min(cfg.sliding_window, kv_len) if kind == "local_attn" else kv_len
        total += 4.0 * batch * cfg.num_heads * hd * ctx
    return total


def estimate_phase(
    *,
    name: str,
    flops: float,
    bytes_moved: float,
    collective_bytes: float,
    hw: HardwareSpec,
    n_devices: int,
    mode: str,
    overhead_s: float,
) -> PhaseEstimate:
    n_par = 1 if mode == "naive_pp" else n_devices
    compute_s = flops / max(n_par * hw.peak_flops_bf16 * hw.eta_compute, 1.0)
    memory_s = bytes_moved / max(n_par * hw.hbm_bw * hw.eta_memory, 1.0)
    coll_bw = max(hw.link_bw * hw.num_links * hw.eta_link, 1.0)
    collective_s = collective_bytes / coll_bw if n_devices > 1 else 0.0
    latency = max(compute_s, memory_s) + collective_s + overhead_s
    bound = max(
        (("compute", compute_s), ("memory", memory_s), ("collective", collective_s)),
        key=lambda kv: kv[1],
    )[0]
    c_frac = compute_s / latency
    m_frac = memory_s / latency
    tdp = hw.rail_tdp_watts or hw.tdp_watts
    idle = hw.rail_idle_watts if hw.rail_idle_watts >= 0 else hw.idle_watts
    if hw.kind == "edge":
        # GPU-rail sensor: DRAM traffic barely shows (see module doc)
        util = 0.7 * c_frac + 0.18 * m_frac
        idle = hw.rail_idle_watts if hw.rail_idle_watts >= 0 else idle
        per_dev = idle + tdp * ETA_POWER * util
    else:
        util = max(c_frac, m_frac)
        per_dev = idle + (tdp - idle) * ETA_POWER * util
    if mode == "naive_pp" and n_devices > 1:
        watts = per_dev + (n_devices - 1) * idle
    else:
        watts = per_dev * n_devices
    return PhaseEstimate(
        name=name, latency_s=latency, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bound=bound, avg_watts=watts,
        joules=watts * latency, flops=flops, bytes_moved=bytes_moved,
    )


def estimate_workload(
    cfg: ModelConfig,
    *,
    hardware: str = "a6000",
    n_devices: int = 1,
    mode: str = "tp",
    batch: int = 1,
    prompt_len: int = 512,
    gen_len: int = 512,
    itemsize: int = 2,
) -> WorkloadEstimate:
    hw = get_hardware(hardware)
    size = size_prof.profile_size(cfg)
    param_bytes = size.param_bytes
    active_bytes = size.active_param_bytes
    active_params = size.active_param_count
    d = cfg.d_model

    # ---- TTFT (prefill) -----------------------------------------------------
    tokens = batch * prompt_len
    flops_pre = 2.0 * active_params * tokens + attention_flops_prefill(
        cfg, batch, prompt_len)
    cache_rep = cache_prof.profile_cache(cfg, batch, prompt_len + gen_len)
    act_bytes = 14.0 * tokens * d * (len(cfg.blocks()) + (cfg.num_encoder_layers or 0))
    kv_write = cache_rep.kv_bytes * min(1.0, prompt_len / max(prompt_len + gen_len, 1))
    bytes_pre = param_bytes + act_bytes + kv_write + cache_rep.state_bytes
    # tensor-parallel: 2 all-reduces of (tokens × d) per layer, ring ≈ 2(n-1)/n
    coll_pre = 0.0
    if n_devices > 1 and mode == "tp":
        ring = 2.0 * (n_devices - 1) / n_devices
        coll_pre = 2 * len(cfg.blocks()) * tokens * d * itemsize * ring
    ttft = estimate_phase(
        name="ttft", flops=flops_pre, bytes_moved=bytes_pre,
        collective_bytes=coll_pre, hw=hw, n_devices=n_devices, mode=mode,
        overhead_s=hw.launch_overhead_s * (len(cfg.blocks()) / 8 if mode == "naive_pp" else 1),
    )

    # ---- TPOT (one decode step at mid-generation KV length) ------------------
    kv_len = prompt_len + gen_len // 2
    cache_mid = cache_prof.profile_cache(cfg, batch, kv_len)
    flops_dec = 2.0 * active_params * batch + attention_flops_decode(cfg, batch, kv_len)
    bytes_dec = (
        active_bytes                      # stream active weights
        + cache_mid.kv_bytes              # read KV
        + 2.0 * cache_mid.state_bytes     # recurrent state read+write
        + cache_mid.cross_bytes
        + 2.0 * batch * d * len(cfg.blocks()) * itemsize * 14.0 / 14.0
    )
    coll_dec = 0.0
    if n_devices > 1 and mode == "tp":
        ring = 2.0 * (n_devices - 1) / n_devices
        coll_dec = 2 * len(cfg.blocks()) * batch * d * itemsize * ring
    tpot = estimate_phase(
        name="tpot", flops=flops_dec, bytes_moved=bytes_dec,
        collective_bytes=coll_dec, hw=hw, n_devices=n_devices, mode=mode,
        overhead_s=hw.launch_overhead_s,
    )

    # ---- TTLT ----------------------------------------------------------------
    lat = ttft.latency_s + max(gen_len - 1, 0) * tpot.latency_s
    joules = ttft.joules + max(gen_len - 1, 0) * tpot.joules
    ttlt = PhaseEstimate(
        name="ttlt", latency_s=lat,
        compute_s=ttft.compute_s + (gen_len - 1) * tpot.compute_s,
        memory_s=ttft.memory_s + (gen_len - 1) * tpot.memory_s,
        collective_s=ttft.collective_s + (gen_len - 1) * tpot.collective_s,
        bound=tpot.bound, avg_watts=joules / max(lat, 1e-9), joules=joules,
        flops=ttft.flops + (gen_len - 1) * tpot.flops,
        bytes_moved=ttft.bytes_moved + (gen_len - 1) * tpot.bytes_moved,
    )
    return WorkloadEstimate(
        arch=cfg.name, hardware=hardware, n_devices=n_devices, mode=mode,
        batch=batch, prompt_len=prompt_len, gen_len=gen_len,
        ttft=ttft, tpot=tpot, ttlt=ttlt,
    )
