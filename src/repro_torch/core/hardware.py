"""Hardware spec registry for estimator-mode profiling and roofline
analysis, the counterpart of ``repro/core/hardware.py``.

The paper's platforms (A6000, Jetson Orin Nano, Jetson AGX Thor) and the
CPU dev rig keep the reference's values unchanged, so the two estimators
agree on them.  The reference's TPU entry is left out: the port states no
figure for a TPU.  ``h100`` is the card the port runs on, an H100 SXM5
80GB HBM3, from NVIDIA's published figures; its idle power and its
``eta_*`` derates were measured on that card (``chip_smoke.py``).
``eta_*`` are achievable-fraction derates used by the latency estimator
(sustained / peak).
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    kind: str                  # gpu | edge | cpu
    peak_flops_bf16: float     # FLOP/s per chip (bf16/fp16 tensor)
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per inter-chip link (NVLink / PCIe)
    num_links: int             # links per chip contributing to collectives
    tdp_watts: float           # board power at full load
    idle_watts: float          # board power at idle
    mem_bytes: int             # HBM / unified memory per chip
    eta_compute: float = 0.6   # sustained fraction of peak FLOP/s
    eta_memory: float = 0.75   # sustained fraction of peak HBM BW
    eta_link: float = 0.8      # sustained fraction of peak link BW
    launch_overhead_s: float = 30e-6  # per-step dispatch overhead
    # power as seen by the paper's sensor. Jetson numbers come from the GPU
    # rail (jtop), which excludes DRAM/SoC power -> much lower than board TDP.
    rail_tdp_watts: float = 0.0   # 0 -> use tdp_watts
    rail_idle_watts: float = -1.0  # <0 -> use idle_watts

    def power_at(self, utilization: float) -> float:
        """Board power at a given utilization (linear idle->TDP model).

        This mirrors the paper's measurement method: they average sampled
        instantaneous power over the latency window; we model that average.
        """
        u = min(max(utilization, 0.0), 1.0)
        return self.idle_watts + (self.tdp_watts - self.idle_watts) * u


REGISTRY: Dict[str, HardwareSpec] = {}


def _reg(spec: HardwareSpec) -> HardwareSpec:
    REGISTRY[spec.name] = spec
    return spec


# --- the paper's platforms --------------------------------------------------

A6000 = _reg(HardwareSpec(
    # NVIDIA RTX A6000: 38.7 TF fp32 / 154.8 TF fp16 tensor (dense),
    # 768 GB/s GDDR6, 300 W board, NVLink3 112.5 GB/s (2 bricks).
    name="a6000", kind="gpu",
    peak_flops_bf16=154.8e12, hbm_bw=768e9,
    link_bw=56.25e9, num_links=2,
    tdp_watts=300.0, idle_watts=22.0, mem_bytes=48 * 1000**3,
    eta_compute=0.65, eta_memory=0.85,  # calibrated on paper Table 3 rows
))

JETSON_ORIN_NANO = _reg(HardwareSpec(
    # Orin Nano 8GB: 40 INT8 sparse TOPS ≈ 10 TF fp16 dense, 68 GB/s LPDDR5,
    # 15 W module (7-15 W envelope), unified memory.
    name="jetson-orin-nano", kind="edge",
    peak_flops_bf16=10e12, hbm_bw=68e9,
    link_bw=0.0, num_links=0,
    tdp_watts=15.0, idle_watts=4.0, mem_bytes=8 * 1000**3,
    eta_compute=0.45, eta_memory=0.75,   # calibrated on paper Table 4
    rail_tdp_watts=5.5, rail_idle_watts=0.1,
))

JETSON_AGX_THOR = _reg(HardwareSpec(
    # AGX Thor 128GB devkit: 1 PFLOP fp8 *sparse* -> ~250 TF fp16 dense
    # (Blackwell), 273 GB/s LPDDR5X, 40-130 W envelope.  eta calibrated on
    # paper Table 4 (power-capped devkit sustains ~22% of dense peak).
    name="jetson-agx-thor", kind="edge",
    peak_flops_bf16=250e12, hbm_bw=273e9,
    link_bw=0.0, num_links=0,
    tdp_watts=130.0, idle_watts=15.0, mem_bytes=128 * 1000**3,
    eta_compute=0.22, eta_memory=0.60,
    rail_tdp_watts=78.0, rail_idle_watts=1.0,
))

# --- the port's card --------------------------------------------------------

H100 = _reg(HardwareSpec(
    # NVIDIA H100 SXM5 80GB HBM3, published: 989 TFLOP/s bf16 dense,
    # 3.35 TB/s HBM3, 700 W, NVLink 4 as 18 links of 25 GB/s, 80 GB.
    name="h100", kind="gpu",
    peak_flops_bf16=989e12, hbm_bw=3.35e12,
    link_bw=25e9, num_links=18,
    tdp_watts=700.0, mem_bytes=80 * 1000**3,
    # NVML board power before any model is drawn, median of 20 reads
    # (chip_smoke.py; NVIDIA H100 80GB HBM3 at a 700.00 W limit)
    idle_watts=73.2,
    # calibrated so that estimate_workload gives llama3.1-8b (B = 1, prompt
    # 512, 32 generated) the TTFT (24.11 ms, eager prefill) and CUDA-graph
    # TPOT (7.72 ms) chip_smoke.py measured on an NVIDIA H100 80GB HBM3 at
    # a 700.00 W limit; the eager prefill is host-bound, so eta_compute is
    # the host's share as much as the tensor cores'
    eta_compute=0.348,
    eta_memory=0.626,
))

CPU_DEV = _reg(HardwareSpec(
    # The CPU dev container (measured-mode sanity runs only).
    name="cpu", kind="cpu",
    peak_flops_bf16=0.2e12, hbm_bw=20e9,
    link_bw=0.0, num_links=0,
    tdp_watts=65.0, idle_watts=10.0, mem_bytes=32 * 1000**3,
    eta_compute=0.5, eta_memory=0.5,
))


def get_hardware(name: str) -> HardwareSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown hardware {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
