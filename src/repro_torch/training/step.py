"""The train step: loss, gradient accumulation, clipping and AdamW, the
counterpart of ``repro/training/step.py``.

``make_train_step`` returns ``train_step(state, batch)``, which updates
the state in place (the model's parameters, the moments, the counts) and
returns the reference's metrics.  Gradients come from
``torch.autograd.grad`` through ``Model.forward_train``; with
``microbatches`` > 1 the batch is cut into that many consecutive row
blocks, their gradients summed in fp32 and divided by the count, as the
reference's ``lax.scan`` accumulation.

On a ``("data", "model")`` mesh (``mesh=``, a ``launch.mesh.Mesh``; the
model a rank's shard from ``sharding.partition``) every rank is given the
same global batch.  Microbatch i is rows ``[i·B/m, (i+1)·B/m)`` of it,
then cut over the data ranks (``partition.batch_rows``), as the
reference's reshape-then-shard; a microbatch data does not divide is
whole on every data rank.  The loss is the global microbatch's mean:
each rank's sum of ``nll·mask`` over the global denominator, the sums
all-reduced over data, and so are ``accuracy`` and ``tokens``.  The
gradients leave the backward as the rank's shards (FSDP's
reduce-scatter), the replicated leaves' are all-reduced over data, the
global norm counts each leaf once (``clip_by_global_norm(placement=)``),
and AdamW runs on the shards unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import partition
from repro_torch.training.optimizer import AdamW, OptState, clip_by_global_norm, reference_ndims

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the reference's ``params``), the
    optimizer's state and the number of steps taken."""
    model: model_lib.Model
    opt: OptState
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def train_state(model: model_lib.Model, optimizer: AdamW) -> TrainState:
    """A state at step 0 for ``model`` (drawn or bridged), its parameters
    set to require grad."""
    for p in model.parameters():
        p.requires_grad_(True)
    return TrainState(model=model, opt=optimizer.init(dict(model.named_parameters())))


def init_state(cfg: ModelConfig, optimizer: AdamW, generator: torch.Generator,
               device="cuda") -> TrainState:
    """A model drawn from ``generator`` (which lives on ``device``) and its
    optimizer state."""
    return train_state(model_lib.init(cfg, generator, device), optimizer)


def token_count(batch: Batch) -> torch.Tensor:
    """The positions a batch's loss counts (its ``loss_mask``'s sum, or
    every label), fp32."""
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.tensor(float(batch["labels"].numel()), device=batch["labels"].device)
    return mask.float().sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, z_loss: float = 1e-4,
                  denom: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy over the positions ``mask`` counts
    (all by default), plus PaLM's ``z_loss * lse^2``; logits (B, S, V),
    labels (B, S).  ``denom``: the count to divide by, where these rows
    are a data rank's part of a batch (the global count); the mask's own
    sum by default.  Returns (loss, {loss, accuracy, tokens})."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - true_logit
    if z_loss > 0:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    mask = mask.float()
    denom = torch.clamp(mask.sum() if denom is None else denom, min=1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(dim=-1) == labels) * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": denom}


def make_loss_fn(cfg: ModelConfig, remat: bool = True
                 ) -> Callable[[model_lib.Model, Batch], Tuple[torch.Tensor, Dict]]:
    def loss_fn(model: model_lib.Model, batch: Batch, denom: Optional[torch.Tensor] = None):
        logits = model.forward_train(batch, remat=remat)
        labels = batch["labels"]
        if cfg.num_vision_tokens and logits.shape[1] != labels.shape[1]:
            logits = logits[:, cfg.num_vision_tokens:]  # text positions only
        return cross_entropy(logits, labels, batch.get("loss_mask"), denom=denom)

    return loss_fn


def _microbatch_grads(loss_fn, model, params, batch, mesh):
    """One microbatch's (loss, metrics, gradients by name)."""
    if mesh is None:
        loss, aux = loss_fn(model, batch)
        return loss, aux, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    rows, summed = partition.batch_rows(batch, mesh)
    model.fsdp.set_rows(summed)
    tokens = token_count(rows)
    if summed:
        tokens = mesh.data.all_reduce(tokens)
    loss, aux = loss_fn(model, rows, denom=tokens)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    if summed:  # the data ranks' sums of the global mean's terms
        both = mesh.data.all_reduce(torch.stack([aux["loss"], aux["accuracy"]]))
        aux = dict(aux, loss=both[0], accuracy=both[1])
    return aux["loss"], aux, grads


def grads_of(loss_fn, model: model_lib.Model, batch: Batch, mesh=None, microbatches: int = 1
             ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """The metrics of ``batch`` (``loss``: the microbatches' mean;
    ``accuracy`` and ``tokens``: the last microbatch's) and every
    parameter's gradient before clipping, the gradient half of the train
    step: with ``microbatches`` > 1 summed in fp32 and divided by their
    count; on ``mesh`` the rank's shards, the replicated leaves' summed
    over data.  ``model``'s parameters must require grad
    (``train_state``)."""
    params = dict(model.named_parameters())
    if microbatches > 1:
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} is not a multiple of {microbatches} microbatches")
        b = B // microbatches
        grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        loss_sum = 0.0
        for i in range(microbatches):
            loss, aux, g = _microbatch_grads(loss_fn, model, params,
                                             {k: v[i * b:(i + 1) * b] for k, v in batch.items()},
                                             mesh)
            torch._foreach_add_(list(grads.values()), [x.float() for x in g.values()])
            loss_sum = loss_sum + loss.detach()
            del g
        torch._foreach_div_(list(grads.values()), microbatches)
        aux = dict(aux, loss=loss_sum / microbatches)
    else:
        _, aux, grads = _microbatch_grads(loss_fn, model, params, batch, mesh)
    if mesh is not None:
        model.fsdp.sync_replicated(grads)
    return aux, grads


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *, remat: bool = True,
                    microbatches: int = 1, clip_norm: float = 1.0, mesh=None
                    ) -> Callable[[TrainState, Batch], Dict]:
    """A step that updates ``state`` in place and returns the metrics
    ``loss`` (the microbatches' mean), ``accuracy`` and ``tokens`` (the
    last microbatch's), ``grad_norm`` (before clipping) and ``lr`` (of the
    update just made).  The tensors among them stay on the device:
    nothing here waits for it (but a mesh's collectives).  ``mesh``: a
    ``launch.mesh.Mesh`` whose rank's shard ``state.model`` is; the step
    is then given the global batch."""
    loss_fn = make_loss_fn(cfg, remat=remat)
    ndims: Dict[str, int] = {}  # reference_ndims, filled on the first step

    def train_step(state: TrainState, batch: Batch) -> Dict:
        params = state.params()
        aux, grads = grads_of(loss_fn, state.model, batch, mesh, microbatches)
        grads, gnorm = clip_by_global_norm(grads, clip_norm,
                                           state.model.placement if mesh is not None else None)
        if not ndims:
            ndims.update(reference_ndims(cfg, params))
        optimizer.update(grads, state.opt, params, ndims)
        state.step += 1
        return dict(aux, grad_norm=gnorm, lr=optimizer.schedule(state.opt.count))

    return train_step
