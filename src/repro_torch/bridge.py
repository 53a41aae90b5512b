"""Load parameters of the reference package into a port ``Model``.

``params_from_jax(cfg, tree)`` takes the reference's ``model.init`` params
as a nested dict of numpy arrays (bf16 arrays arrive as numpy's bfloat16
extension type and are moved through a ``uint16`` view, so no numpy
bfloat16 support is needed here).  The reference stacks each repetition of
``cfg.block_pattern`` on a leading layer axis under ``decoder.groups.<i>``
and keeps a remainder under ``decoder.rest.<i>``; both are unstacked into
the per-layer modules, layer ``g * len(pattern) + i`` for group ``g``.  An
encoder-decoder model's ``encoder`` stack (pattern ``("attn",)``) is
unstacked the same way into ``encoder.layers``.  With ``mesh=`` (a
``launch.mesh.TPMesh``) the model is the rank's tensor-parallel shard, and
each parameter takes the rank's slice of the reference's
(``sharding.rules.local_slice``, by its owning module's rule), as ``sharding.partition.shard_model``
slices the port's own draws.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, _enc_cfg
from repro_torch.sharding.rules import check_tp, local_slice, param_rules


def as_tensor(arr: np.ndarray) -> torch.Tensor:
    """A numpy array (bf16 through a uint16 view) as a CPU tensor."""
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


def reference_by_port_name(cfg: ModelConfig, tree: Mapping) -> Dict[str, np.ndarray]:
    """The leaves of a tree shaped like the reference's params (its
    parameters, or their gradients or moments) by the port's parameter
    names: each stacked group leaf split into its layers."""
    # each stack: (its config, the port's prefix of its modules)
    stacks = {"decoder": (cfg, "")}
    if cfg.is_encdec:
        stacks["encoder"] = (_enc_cfg(cfg), "encoder.")
    flat: Dict[str, np.ndarray] = {}
    for name, arr in _flatten(tree).items():
        parts = name.split(".")
        if parts[0] not in stacks:
            flat[name] = arr
            continue
        scfg, prefix = stacks[parts[0]]
        plen = len(scfg.block_pattern)
        n_groups, _ = scfg.layer_groups()
        if parts[1] == "groups":
            i, leaf = int(parts[2]), ".".join(parts[3:])
            for g in range(arr.shape[0]):
                flat[f"{prefix}layers.{g * plen + i}.{leaf}"] = arr[g]
        elif parts[1] == "rest":
            i, leaf = int(parts[2]), ".".join(parts[3:])
            flat[f"{prefix}layers.{n_groups * plen + i}.{leaf}"] = arr
        else:
            flat[prefix + ".".join(parts[1:])] = arr
    return flat


def params_from_jax(cfg: ModelConfig, tree: Mapping, device="cuda", mesh=None) -> Model:
    """A ``Model`` on ``device`` holding the reference parameters ``tree``
    (with ``mesh``, the rank's tensor-parallel serving shard of them:
    ``sharding.rules.check_tp`` refuses what it cannot serve)."""
    if mesh is not None:
        check_tp(cfg, mesh.size)
    model = Model(cfg, device=device, mesh=mesh)
    rank, tp = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    flat = reference_by_port_name(cfg, tree)
    params = dict(model.named_parameters())
    rules = param_rules(model)
    if set(flat) != set(params):
        raise ValueError(f"parameter names differ: only in the reference "
                         f"{sorted(set(flat) - set(params))}, only in the port "
                         f"{sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            src = as_tensor(local_slice(rules[name], flat[name], rank, tp))
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(src.shape)} {src.dtype}, "
                                 f"port {tuple(p.shape)} {p.dtype}")
            p.copy_(src)
    return model
