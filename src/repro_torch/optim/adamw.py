"""AdamW with decoupled weight decay, ported by hand from
``repro.optim.adamw`` to its exact arithmetic: the global-norm clip in
f32, bias correction with ``eps`` outside the square root, f32 moments
``mu``/``nu`` and parameters kept in their own dtype.  Which tensors take
weight decay is the caller's ``decay`` list: the reference decides on its
layer-stacked tree (``src/repro/optim/adamw.py:57``), and
``models.convert.decay_mask`` carries that rule to the port's per-layer
tensors.  (``torch.optim.AdamW`` puts the decay and the bias correction
elsewhere and computes something else.)

The update works on the parameters in place, one tensor at a time, so
the f32 temporaries of one tensor are alive at once, not the model's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Union)

import torch


class AdamWState(NamedTuple):
    step: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamWState(step=0, mu=zeros,
                          nu=[torch.zeros_like(z) for z in zeros])

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        return self.lr(step) if callable(self.lr) \
            else _f32(self.lr, step.device)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor], decay: Sequence[bool],
               norm_groups: Optional[Sequence[Any]] = None):
        """Update ``params`` in place from ``grads``, adding weight decay to
        the tensors whose ``decay`` entry is true; returns (new state, the
        f32 global gradient norm before clipping).

        The norm is over the whole model's gradient: ``norm_groups``
        gives, per tensor, the process group its shards split over on a
        grid (None, and no ``norm_groups`` at all: every rank holds all of
        it), and each group's sum of squares is all-reduced over it once,
        so a split tensor counts each shard once and a replicated one
        once."""
        if len(decay) != len(params):
            raise ValueError(f"{len(decay)} decay flags for {len(params)} "
                             f"parameters")
        dev = params[0].device
        step = state.step + 1
        if self.grad_clip:
            gnorm = torch.sqrt(_sq_norm(grads, norm_groups
                                        or [None] * len(grads)))
            scale = torch.clamp(_f32(self.grad_clip, dev) / (gnorm + 1e-9),
                                max=1.0)
        else:
            gnorm = _f32(0.0, dev)
            scale = _f32(1.0, dev)
        step_f = _f32(float(step), dev)
        lr = self._lr(step_f)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - _f32(b1, dev) ** step_f
        bc2 = 1 - _f32(b2, dev) ** step_f
        for g, m, v, p, d in zip(grads, state.mu, state.nu, params, decay):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if d:
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        return AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm


def _sq_norm(grads, norm_groups) -> torch.Tensor:
    """The squared global norm of gradients split over process groups:
    the tensors' squares summed in order by group (groups in order of
    first appearance), each group's sum all-reduced over it (None: not
    split), the sums added in that order."""
    import torch.distributed as dist
    sums: dict = {}
    for g, grp in zip(grads, norm_groups):
        sq = torch.sum(torch.square(g.float()))
        key = id(grp)
        sums[key] = (grp, sq if key not in sums else sums[key][1] + sq)
    total = None
    for grp, sq in sums.values():
        if grp is not None:
            dist.all_reduce(sq, group=grp)
        total = sq if total is None else total + sq
    return total


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, cosine decay to ``floor_frac`` of it;
    ``lr(step)`` takes and returns an f32 scalar tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr
