"""The train step: loss, gradient accumulation, clipping and AdamW, the
counterpart of ``repro/training/step.py``.

``make_train_step`` returns ``train_step(state, batch)``, which updates
the state in place (the model's parameters, the moments, the counts) and
returns the reference's metrics.  Gradients come from
``torch.autograd.grad`` through ``Model.forward_train``; with
``microbatches`` > 1 the batch is cut into that many consecutive row
blocks, their gradients summed in fp32 and divided by the count, as the
reference's ``lax.scan`` accumulation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, z_loss: float = 1e-4
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy over the positions ``mask`` counts
    (all by default), plus PaLM's ``z_loss * lse^2``; logits (B, S, V),
    labels (B, S).  Returns (loss, {loss, accuracy, tokens})."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - true_logit
    if z_loss > 0:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(dim=-1) == labels) * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": denom}


def make_loss_fn(cfg: ModelConfig, remat: bool = True
                 ) -> Callable[[model_lib.Model, Batch], Tuple[torch.Tensor, Dict]]:
    def loss_fn(model: model_lib.Model, batch: Batch):
        logits = model.forward_train(batch, remat=remat)
        labels = batch["labels"]
        if cfg.num_vision_tokens and logits.shape[1] != labels.shape[1]:
            logits = logits[:, cfg.num_vision_tokens:]  # text positions only
        return cross_entropy(logits, labels, batch.get("loss_mask"))

    return loss_fn


def make_train_step(cfg: ModelConfig, optimizer: AdamW, *, remat: bool = True,
                    microbatches: int = 1, clip_norm: float = 1.0
                    ) -> Callable[[TrainState, Batch], Dict]:
    """A step that updates ``state`` in place and returns the metrics
    ``loss`` (the microbatches' mean), ``accuracy`` and ``tokens`` (the
    last microbatch's), ``grad_norm`` (before clipping) and ``lr`` (of the
    update just made).  The tensors among them stay on the device:
    nothing here waits for it."""
    loss_fn = make_loss_fn(cfg, remat=remat)
    ndims: Dict[str, int] = {}  # reference_ndims, filled on the first step

    def grads_of(model, params, batch):
        loss, aux = loss_fn(model, batch)
        return loss, aux, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    def train_step(state: TrainState, batch: Batch) -> Dict:
        params = state.params()
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} is not a multiple of {microbatches} microbatches")
            b = B // microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            loss_sum = 0.0
            for i in range(microbatches):
                loss, aux, g = grads_of(state.model, params,
                                        {k: v[i * b:(i + 1) * b] for k, v in batch.items()})
                torch._foreach_add_(list(grads.values()), [x.float() for x in g.values()])
                loss_sum = loss_sum + loss.detach()
                del g
            torch._foreach_div_(list(grads.values()), microbatches)
            aux = dict(aux, loss=loss_sum / microbatches)
        else:
            _, aux, grads = grads_of(state.model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        if not ndims:
            ndims.update(reference_ndims(cfg, params))
        optimizer.update(grads, state.opt, params, ndims)
        state.step += 1
        return dict(aux, grad_norm=gnorm, lr=optimizer.schedule(state.opt.count))

    return train_step
