"""AdamW, its learning-rate schedules and gradient clipping, the
counterpart of ``repro/training/optimizer.py``.

The arithmetic is the reference's: fp32 moments whatever the parameter
dtype, bias correction, ``eps`` outside the square root, the decay added
to the step, and one rounding of the new parameter to its dtype (so a
bf16 parameter is not rounded twice, as ``torch.optim.AdamW`` would).
Everything happens in place on the caller's tensors, a bucket of
parameters at a time through ``torch._foreach_*``, so the fp32 temporaries
never hold more than one bucket.

Which parameters decay is the reference's rule, read on the reference's
tree: a leaf decays if it has two or more dimensions.  The reference
stacks each repetition of ``block_pattern`` on a leading axis
(``decoder.groups``), so a norm scale inside a group is 2-D there and
decays, while the same scale in a remainder layer (``decoder.rest``) or
the final norm does not.  The port's layers are unstacked, so
``reference_ndims`` gives each parameter the dimension count its leaf has
in the reference's tree, from the config alone.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]
# fp32 elements of one bucket of the update's temporaries (1 GiB each)
BUCKET_NUMEL = 1 << 28


@dataclasses.dataclass
class OptState:
    """fp32 first and second moments by parameter name, and the number of
    updates made."""
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(np.float32(lr))


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                           min_ratio: float = 0.1) -> Schedule:
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``min_ratio * peak_lr`` at ``total_steps``; in fp32, as the reference."""
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(peak_lr) * min(f32(1.0), s / f32(max(warmup_steps, 1))))
        frac = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(min_ratio) + f32(1 - min_ratio) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
        return float(f32(peak_lr) * cos)

    return fn


def reference_ndims(cfg, params: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """The dimension count of each named parameter's leaf in the
    reference's tree: one more than the port's tensor for a layer inside
    one of the full repetitions of a stack's pattern, which the reference
    stacks (``layers.<i>.*`` for i below ``n_groups * len(pattern)`` of
    ``cfg.layer_groups()``; every ``encoder.layers.<i>.*``, the encoder's
    pattern being one attention block); the port's own count elsewhere.
    ``params`` maps each parameter's name to its tensor."""
    n_groups, _ = cfg.layer_groups()
    grouped = n_groups * len(cfg.block_pattern)
    out = {}
    for name, p in params.items():
        m = re.match(r"(encoder\.)?layers\.(\d+)\.", name)
        out[name] = p.dim() + (1 if m and (m.group(1) or int(m.group(2)) < grouped) else 0)
    return out


def _buckets(names: List[str], params: Dict[str, torch.Tensor]) -> Iterator[List[str]]:
    bucket, numel = [], 0
    for name in names:
        if bucket and numel + params[name].numel() > BUCKET_NUMEL:
            yield bucket
            bucket, numel = [], 0
        bucket.append(name)
        numel += params[name].numel()
    if bucket:
        yield bucket


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # decay only matrices (embeddings/projections), not norms/biases, as
    # counted on the reference's tree
    decay_min_ndim: int = 2

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return OptState(mu=zeros, nu={k: torch.zeros_like(z) for k, z in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor], ndims: Dict[str, int]) -> None:
        """One step: ``params``, ``state.mu``/``nu`` and ``state.count``
        updated in place.  ``ndims`` gives each parameter the dimension
        count that decides its decay: ``reference_ndims`` for a model's
        parameters."""
        state.count += 1
        lr = self.schedule(state.count)
        b1c = 1.0 - float(np.float32(self.b1) ** np.float32(state.count))
        b2c = 1.0 - float(np.float32(self.b2) ** np.float32(state.count))
        names = list(params)
        for bucket in _buckets(names, params):
            ps = [params[k] for k in bucket]
            gs = [grads[k].float() for k in bucket]
            mus, nus = [state.mu[k] for k in bucket], [state.nu[k] for k in bucket]
            torch._foreach_mul_(mus, self.b1)
            torch._foreach_add_(mus, gs, alpha=1 - self.b1)
            torch._foreach_mul_(nus, self.b2)
            torch._foreach_addcmul_(nus, gs, gs, value=1 - self.b2)
            denom = torch._foreach_div(nus, b2c)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            steps = torch._foreach_div(mus, b1c)
            torch._foreach_div_(steps, denom)
            del denom, gs
            pf = [p.float() for p in ps]
            decay = [i for i, k in enumerate(bucket) if ndims[k] >= self.decay_min_ndim]
            if decay and self.weight_decay:
                torch._foreach_add_([steps[i] for i in decay], [pf[i] for i in decay],
                                    alpha=self.weight_decay)
            # p - lr * step in fp32, rounded once to the parameter's dtype
            new = torch._foreach_add(pf, steps, alpha=-lr)
            for p, n in zip(ps, new):
                p.copy_(n)


def _sum_squares(grads: List[torch.Tensor], device) -> torch.Tensor:
    if not grads:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)).square().sum()


def global_norm(grads: Dict[str, torch.Tensor], placement=None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in fp32 (a 0-d tensor
    on the gradients' device: nothing waits for it but a mesh's
    collectives).  ``placement`` (``sharding.partition.Placement``): the
    gradients are a rank's shards; each class of leaf (split over both
    axes, data only, model only, neither) sums its squares over the axes
    it splits over, so a leaf whole on several ranks counts once (a
    leaf split over the pods only, once per pod)."""
    if placement is None:
        return _sum_squares(list(grads.values()), None).sqrt()
    device = next(iter(grads.values())).device
    parts, pods = {}, {}
    for name, g in grads.items():
        key = placement.sharded(name)
        shared = key[0] and placement.data_replicas(name) > 1
        (pods if shared else parts).setdefault(key, []).append(g)
    sums = {key: _sum_squares(parts.get(key, []), device)
            for key in ((True, True), (True, False), (False, True), (False, False))}
    for key, gs in pods.items():  # a pod's shard is on dp / pods data ranks: once
        sums[key] = sums[key] + _sum_squares(gs, device) / (placement.dp // placement.pods)
    over_data = placement.data.all_reduce(torch.stack([sums[True, True], sums[True, False]]))
    over_model = placement.model.all_reduce(torch.stack([over_data[0], sums[False, True]]))
    return (over_model[0] + over_data[1] + over_model[1] + sums[False, False]).sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float, placement=None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every gradient times min(1, max_norm / (norm + 1e-9)), computed in
    fp32 and cast back to the gradient's dtype, in place (one gradient's
    fp32 copy at a time); returns (the gradients, the norm before
    clipping).  ``placement``: the gradients are a rank's shards
    (``global_norm``)."""
    norm = global_norm(grads, placement)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, norm

