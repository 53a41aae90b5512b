"""Load parameters of the reference package into a port ``Model``.

``params_from_jax(cfg, tree)`` takes the reference's ``model.init`` params
as a nested dict of numpy arrays (bf16 arrays arrive as numpy's bfloat16
extension type and are moved through a ``uint16`` view, so no numpy
bfloat16 support is needed here).  The reference stacks each repetition of
``cfg.block_pattern`` on a leading layer axis under ``decoder.groups.<i>``
and keeps a remainder under ``decoder.rest.<i>``; both are unstacked into
the per-layer modules, layer ``g * len(pattern) + i`` for group ``g``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch.from_numpy wants writable memory
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def params_from_jax(cfg: ModelConfig, tree: Mapping, device="cuda") -> Model:
    """A ``Model`` on ``device`` holding the reference parameters ``tree``."""
    model = Model(cfg, device=device)
    plen = len(cfg.block_pattern)
    n_groups, _ = cfg.layer_groups()
    flat: Dict[str, np.ndarray] = {}
    for name, arr in _flatten(tree).items():
        parts = name.split(".")
        if parts[:2] == ["decoder", "groups"]:
            i, leaf = int(parts[2]), ".".join(parts[3:])
            for g in range(arr.shape[0]):
                flat[f"layers.{g * plen + i}.{leaf}"] = arr[g]
        elif parts[:2] == ["decoder", "rest"]:
            i, leaf = int(parts[2]), ".".join(parts[3:])
            flat[f"layers.{n_groups * plen + i}.{leaf}"] = arr
        elif parts[0] == "decoder":
            flat[".".join(parts[1:])] = arr
        else:
            flat[name] = arr
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"parameter names differ: only in the reference "
                         f"{sorted(set(flat) - set(params))}, only in the port "
                         f"{sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            src = _tensor(flat[name])
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(src.shape)} {src.dtype}, "
                                 f"port {tuple(p.shape)} {p.dtype}")
            p.copy_(src)
    return model
