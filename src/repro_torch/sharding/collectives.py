"""Collectives that autograd can differentiate, the counterpart of the
reshards that GSPMD places (and differentiates) around the reference's
sharding constraints.

The tensor-parallel model keeps each activation either *replicated* (the
same bytes on every rank of the model axis, and so the same gradient) or
*rank-local* (a rank's slice, or a partial sum).  Four functions move
between the two, each with its backward:

* ``reduce(t, mesh)``: partial sums -> replicated; forward all-reduces,
  backward is the identity (each partial's gradient is the sum's).
* ``copy(t, mesh)``: replicated -> rank-local use; forward is the
  identity, backward all-reduces.  It goes wherever a replicated tensor
  enters rank-local arithmetic: the residual stream's norm before
  column-parallel weights, a whole weight that one rank's heads read, a
  gathered row before the rank takes its columns.  Without it the
  gradient into the residual stream and into the replicated leaves would
  be one rank's partial sum.
* ``gather(t, dim, mesh)``: rank-local slices -> replicated whole; forward
  all-gathers along ``dim``, backward takes the rank's slice of the
  (replicated) gradient.
* ``fsdp_gather(shard, dim, mesh, summed)``: a parameter's data shard ->
  the whole (model-shard) parameter; forward all-gathers over the data
  axis, backward reduce-scatters the gradient, summing the data ranks'
  (``summed``: their rows differ) or, for a batch every data rank holds
  whole, taking the rank's slice of the gradient they share; a leaf split
  over the pods only (``over``: the wider data axis the rows split over)
  has its gradient all-reduced over that axis and takes its part.

With grad off, or on a tensor that needs none, each is the plain
collective (or nothing), so the serving paths and their CUDA-graph
captures are unchanged.  ``mesh`` is a ``launch.mesh.TPMesh`` (one axis).
"""

from __future__ import annotations

import torch


def _differentiable(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _summed(mesh, t: torch.Tensor) -> torch.Tensor:
    """The all-reduce of ``t`` without writing into ``t`` (the plain
    collective reduces a device or CPU tensor in place)."""
    return mesh.all_reduce(t if mesh.staged else t.clone())


def _slice(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).contiguous()


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return _summed(mesh, t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _summed(ctx.mesh, g.contiguous()), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return mesh.gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.mesh.rank, ctx.mesh.size), None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, mesh, summed, over):
        ctx.dim, ctx.mesh, ctx.summed, ctx.over = dim, mesh, summed, over
        return mesh.gather(shard, dim)

    @staticmethod
    def backward(ctx, g):
        none = (None,) * 4
        if not ctx.summed:
            return (_slice(g, ctx.dim, ctx.mesh.rank, ctx.mesh.size),) + none
        if ctx.over is None:
            return (ctx.mesh.reduce_scatter(g.contiguous(), ctx.dim),) + none
        # the rows split over the whole data axis: its sum, the pod's part
        return (_slice(_summed(ctx.over, g.contiguous()), ctx.dim, ctx.mesh.rank,
                       ctx.mesh.size),) + none


def reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the ranks' partials ``t``, the same bytes on every rank."""
    if _differentiable(t):
        return _Reduce.apply(t, mesh)
    return mesh.all_reduce(t)


def copy(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` (replicated) as the input of rank-local arithmetic: itself,
    its gradient summed over the ranks.  Nothing without a mesh."""
    if mesh is None or not _differentiable(t):
        return t
    return _Copy.apply(t, mesh)


def gather(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Each rank's ``t`` side by side along ``dim``, in rank order."""
    dim = dim % t.dim()
    if _differentiable(t):
        return _Gather.apply(t, dim, mesh)
    return mesh.gather(t, dim)


def fsdp_gather(shard: torch.Tensor, dim: int, mesh, summed: bool = True,
                over=None) -> torch.Tensor:
    """A parameter's data shards gathered along ``dim`` over the data axis
    ``mesh``; in the backward its gradient reduce-scattered (``summed``)
    or sliced.  ``over``: the axis the rows split over where it is wider
    than ``mesh`` (the data axis, for a leaf split over the pods only):
    the gradient is all-reduced over it and the rank's part taken."""
    if _differentiable(shard):
        return _FSDPGather.apply(shard, dim, mesh, summed, over)
    return mesh.gather(shard, dim)
