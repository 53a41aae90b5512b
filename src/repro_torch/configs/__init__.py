"""Architecture registry of the port: ``--arch <id>`` lookup.

The port runs every architecture of the reference registry: the dense
decoders, the RG-LRU hybrid (recurrentgemma), the xLSTM family
(nemotron-h-8b's mLSTM hybrid, xlstm-1.3b), the MoE family
(qwen3-moe-30b-a3b, moonshot-v1-16b-a3b with its shared experts), the
encoder-decoder seamless-m4t-large-v2 and the vision-prefix llava-next-34b.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_MODULES: Dict[str, str] = {
    "minitron-4b": "minitron_4b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "command-r-plus-104b": "command_r_plus_104b",
    "llama3.1-8b": "llama31_8b",
    "qwen2.5-7b": "qwen25_7b",
    "llama3.2-1b": "llama32_1b",
    "qwen2.5-1.5b": "qwen25_1_5b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "nemotron-h-8b": "nemotron_h_8b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llava-next-34b": "llava_next_34b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

# the ten-architecture assigned pool, by name in the reference's order (its
# ``ASSIGNED``, the first ten of its registry; this registry's order differs)
ASSIGNED: List[str] = ["minitron-4b", "tinyllama-1.1b", "qwen1.5-0.5b",
                       "command-r-plus-104b", "llava-next-34b", "seamless-m4t-large-v2",
                       "moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b", "xlstm-1.3b",
                       "recurrentgemma-2b"]

# the models profiled in the ELANA paper itself (Tables 2-4), as the
# reference lists them
PAPER: List[str] = ["llama3.1-8b", "qwen2.5-7b", "nemotron-h-8b", "llama3.2-1b",
                    "qwen2.5-1.5b"]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg.validate()


def list_archs() -> List[str]:
    return list(_MODULES)
