"""Collectives of the tensor- and expert-parallel layers on a
``("data", "model")`` grid, each with the backward its forward needs.

The reference states its layouts with sharding constraints and lets
GSPMD insert the collectives; here they are written out, Megatron-SP
style, as ``torch.autograd.Function`` s:

* ``seq_gather``: the residual's sequence shard ``[B, S/M, ...]`` ->
  the whole sequence on every model rank (all-gather), before the q/k/v,
  FFN and expert inputs.  Its backward sums the ranks' partial gradients
  and keeps this rank's shard (reduce-scatter).
* ``seq_scatter``: partial sums ``[B, S, ...]`` (after ``wo``,
  ``w_down``, the experts and the vocab-parallel embedding) -> their sum's
  sequence shard (reduce-scatter).  Its backward all-gathers.
* ``vocab_nll``: the cross-entropy of vocab-parallel logits
  ``[N, V/M]`` from each shard's max and sum of exponentials (the whole
  ``[N, V]`` is never built).  Each token's loss is counted by one model
  rank (its sequence shard's), so the backward first sums the upstream
  gradient over the model ranks.
* ``exchange_rows``: ``all_to_all_single`` with split sizes, for the
  expert-parallel dispatch and return; its backward is the same exchange
  with the splits swapped.
* ``fsdp_gather``: a weight's FSDP shard (split over ``"data"`` on its
  ``dmodel`` dim) -> the tensor the layer reads, all-gathered over the
  data ranks; its backward reduce-scatters the gradient, so a split
  tensor's gradient leaves the backward summed over ``"data"``.
  ``read_weights`` is the one accessor through which the model reads a
  module's weights on a grid.

Reduce-scatters are an all-reduce and a slice, and all-gathers take a
list (``all_gather``): gloo has no reduce-scatter, and the tensor forms
of both are deprecated in recent torch.
"""
from __future__ import annotations

import types
from typing import List, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.parallel import fsdp_dims


def model_rank(ctx) -> int:
    return dist.get_rank(ctx.model_group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return _shard(x, group, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def seq_gather(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _Gather.apply(x, group, dim)


def seq_scatter(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return _SeqScatter.apply(x, group, dim)


def own_seq(x: torch.Tensor, ctx, dim: int = 1) -> torch.Tensor:
    """This model rank's sequence shard of a tensor every model rank
    holds whole (no collective)."""
    return _shard(x, ctx.model_group, dim)


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, start, group):
        n_loc = logits.shape[-1]
        m = logits.max(-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[:, None])
        s = e.sum(-1)
        dist.all_reduce(s, group=group)
        t = target - start
        inside = (t >= 0) & (t < n_loc)
        tl = torch.where(inside, t, 0)
        gold = torch.where(inside, logits.gather(-1, tl[:, None])[:, 0], 0.0)
        dist.all_reduce(gold, group=group)
        ctx.save_for_backward(e / s[:, None], tl, inside)
        ctx.group = group
        return torch.log(s) + m - gold

    @staticmethod
    def backward(ctx, g):
        p, tl, inside = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        grad = p * g[:, None]
        # minus g at each row's gold column where this shard holds it: a
        # scatter of one column a row (adding -0.0 elsewhere changes no
        # bit), with no data-dependent shape, so a meta trace runs it
        grad.scatter_add_(1, tl[:, None],
                          torch.where(inside, -g, -0.0)[:, None])
        return grad, None, None, None


def vocab_nll(logits: torch.Tensor, target: torch.Tensor, start: int,
              group) -> torch.Tensor:
    """Per-token ``logsumexp - gold`` of logits split by vocabulary over
    ``group``: ``logits [N, V/M]`` f32 are this rank's columns
    ``[start, start + V/M)``, ``target [N]`` global ids.  Returns [N] f32
    on every rank; the caller counts each token on one rank."""
    return _VocabNLL.apply(logits, target.long(), start, group)


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send: List[int], recv: List[int], group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), recv, send, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((sum(ctx.send),) + tuple(g.shape[1:]))
        dist.all_to_all_single(out, g.contiguous(), ctx.send, ctx.recv,
                               group=ctx.group)
        return out, None, None, None


def exchange_rows(x: torch.Tensor, send: List[int], recv: List[int],
                  group) -> torch.Tensor:
    """Rows of ``x`` to the group's ranks, ``send[r]`` of them to rank r in
    order; returns the ``sum(recv)`` rows received, by source rank."""
    return _ExchangeRows.apply(x, send, recv, group)


def fsdp_gather(w: torch.Tensor, dim: int, data_group) -> torch.Tensor:
    """This rank's FSDP shard of a weight, all-gathered along ``dim`` over
    ``data_group``; the backward sums the ranks' gradients and keeps this
    rank's shard (``seq_gather``'s collectives on a weight's dim)."""
    return _Gather.apply(w, data_group, dim)


def _read_tensor(t: torch.Tensor, key: str, placements: Mapping,
                 data_group):
    for dim in fsdp_dims(key, placements[key]):
        t = fsdp_gather(t, dim, data_group)
    return t


def read_weights(module, prefix: str, placements: Optional[Mapping],
                 data_group):
    """``module``'s weights as the layers read them.  Without a grid
    (``placements`` None) the module itself.  On a grid, by
    ``model.grid_placements``, each FSDP shard all-gathered over the data
    ranks (``fsdp_gather``) and every other tensor as stored: a
    ``Parameter`` is itself, a ``ParameterDict`` (a layer's weights)
    becomes a dict of them, nested as stored, and a block a namespace of
    its children's dicts with its ``kind``.  ``prefix`` is the module's
    name in ``named_parameters``.  Called inside a layer's
    ``torch.utils.checkpoint`` region, the gathered copies are not kept
    for the backward: the recompute gathers them again."""
    if placements is None:
        return module
    if isinstance(module, torch.Tensor):
        return _read_tensor(module, prefix, placements, data_group)
    if isinstance(module, nn.ParameterDict):
        return {name: read_weights(t, f"{prefix}.{name}", placements,
                                   data_group)
                for name, t in module.items()}
    out = types.SimpleNamespace(kind=module.kind)
    for name, child in module.named_children():
        setattr(out, name, read_weights(child, f"{prefix}.{name}",
                                        placements, data_group))
    return out
