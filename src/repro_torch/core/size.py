"""Model-size profiling (paper §2.2, Table 2), the counterpart of
``repro/core/size.py``.

Sizes are counted from the ``Model`` built on the ``meta`` device: the
exact parameters the runtime would allocate, from shapes alone, with no
memory touched and no random weights drawn.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from torch import nn

from repro_torch.core import units
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


@dataclasses.dataclass
class SizeReport:
    name: str
    param_count: int
    param_bytes: int
    active_param_count: int     # MoE: per-token activated params
    active_param_bytes: int
    by_component: Dict[str, int]  # component -> bytes
    dtype: str

    def fmt(self, unit: str = "GB") -> str:
        lines = [
            f"model: {self.name}",
            f"  params: {self.param_count/1e9:.3f} B "
            f"({units.fmt_bytes(self.param_bytes, unit)}, {self.dtype})",
        ]
        if self.active_param_count != self.param_count:
            lines.append(
                f"  active params/token: {self.active_param_count/1e9:.3f} B "
                f"({units.fmt_bytes(self.active_param_bytes, unit)})"
            )
        for comp, nbytes in sorted(self.by_component.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {comp:<28s} {units.fmt_bytes(nbytes, unit)}")
        return "\n".join(lines)


def _component(name: str) -> str:
    """The reference's component names: ``embed``, ``lm_head`` and
    ``decoder.<attn|rec|mlp|norms>``."""
    parts = name.split(".")
    if parts[0] in ("embed", "lm_head"):
        return parts[0]
    part = parts[2] if parts[0] == "layers" else parts[0]
    return "decoder." + ("norms" if "norm" in part else part)


def profile_size(cfg: ModelConfig, model: Optional[nn.Module] = None) -> SizeReport:
    """Size report of ``model``, or of ``cfg``'s model built on ``meta``.
    The port has no MoE model yet, so every parameter is active."""
    model = model if model is not None else Model(cfg, device="meta")
    count = nbytes = 0
    by_comp: Dict[str, int] = {}
    for name, p in model.named_parameters():
        b = p.numel() * p.element_size()
        count += p.numel()
        nbytes += b
        comp = _component(name)
        by_comp[comp] = by_comp.get(comp, 0) + b
    return SizeReport(name=cfg.name, param_count=count, param_bytes=nbytes,
                      active_param_count=count, active_param_bytes=nbytes,
                      by_component=by_comp, dtype=str(cfg.param_dtype))
