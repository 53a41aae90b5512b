"""Architecture registry of the port: ``--arch <id>`` lookup.

The port runs the dense decoders and the RG-LRU hybrid (recurrentgemma).
The other architectures of the reference registry are known by name and
raise ``KeyError`` until their families are ported.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

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
}

NOT_PORTED: Dict[str, str] = {
    "llava-next-34b": "vlm",
    "seamless-m4t-large-v2": "encdec",
    "moonshot-v1-16b-a3b": "moe",
    "qwen3-moe-30b-a3b": "moe",
    "xlstm-1.3b": "ssm",
    "nemotron-h-8b": "hybrid",
}

# the models profiled in the ELANA paper itself (Tables 2-4), as the
# reference lists them
PAPER: List[str] = ["llama3.1-8b", "qwen2.5-7b", "nemotron-h-8b", "llama3.2-1b",
                    "qwen2.5-1.5b"]


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} ({NOT_PORTED[name]} family) is not "
                       f"ported yet; ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg.validate()


def list_archs() -> List[str]:
    return list(_MODULES)
