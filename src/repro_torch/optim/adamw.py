"""AdamW with decoupled weight decay, ported by hand from
``repro.optim.adamw`` to its exact arithmetic: the global-norm clip in
f32, bias correction with ``eps`` outside the square root, decay on
matrices only, f32 moments ``mu``/``nu`` and parameters kept in their own
dtype.  (``torch.optim.AdamW`` puts the decay and the bias correction
elsewhere and computes something else.)

The update works on the parameters in place, one tensor at a time, so
the f32 temporaries of one tensor are alive at once, not the model's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Sequence, Union

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
               params: Sequence[torch.Tensor]):
        """Update ``params`` in place from ``grads``; returns (new state,
        the f32 global gradient norm before clipping)."""
        dev = params[0].device
        step = state.step + 1
        if self.grad_clip:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
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
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if p.dim() >= 2:  # decay matrices only
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        return AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm


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
