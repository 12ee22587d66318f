"""Optimizer arithmetic of the reference's ``training/optimizer.py`` on
PyTorch — the part the RL learners use: ``adamw``, ``global_norm``,
``clip_by_global_norm`` and ``apply_updates``.

The reference's transforms are pure functions over parameter pytrees; here
they take lists of tensors (a module's ``parameters()`` in order) and
``apply_updates`` adds in place. ``adamw`` keeps the reference's arithmetic
op for op — ``b2 = 0.95``, f32 bias corrections ``1 - b**step``, ``u =
-lr * (mu / bc1) / (sqrt(nu / bc2) + eps)`` and weight decay on leaves of
two or more dimensions only — which ``torch.optim.AdamW`` does not (it
rounds in another order and puts ``eps`` elsewhere).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch

F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor  # i32
    inner: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Sequence[torch.Tensor]], OptState]
    update: Callable[..., Tuple[List[torch.Tensor], OptState]]


class _AdamMoments(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def apply_updates(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]):
    """``p += u`` for every parameter, in place (outside autograd)."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))
    return params


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    total = 0
    for x in tensors:
        total = total + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(total)


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float):
    """(tensors scaled by ``min(1, max_norm / (norm + 1e-9))``, norm)."""
    g = global_norm(tensors)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return [x * scale.to(x.dtype) for x in tensors], g


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """AdamW with f32 moments; the tensors of two or more dimensions decay."""

    def init(params):
        params = list(params)
        dev = params[0].device
        return OptState(
            torch.zeros((), dtype=torch.int32, device=dev),
            _AdamMoments([torch.zeros_like(p, dtype=F32) for p in params],
                         [torch.zeros_like(p, dtype=F32) for p in params]),
        )

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        lr_t = torch.tensor(lr, dtype=F32, device=step.device)
        stepf = step.to(F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=step.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=step.device), stepf)
        params = list(params) if params is not None else [None] * len(grads)
        upds, mus, nus = [], [], []
        for g, mu, nu, p in zip(grads, state.inner.mu, state.inner.nu, params):
            g32 = g.to(F32)
            mu32 = mu * b1 + (1 - b1) * g32
            nu32 = nu * b2 + (1 - b2) * torch.square(g32)
            u = -lr_t * (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
            if weight_decay and p is not None:
                decay = 1.0 if p.dim() >= 2 else 0.0
                u = u - lr_t * weight_decay * decay * p.to(F32)
            upds.append(u)
            mus.append(mu32)
            nus.append(nu32)
        return upds, OptState(step, _AdamMoments(mus, nus))

    return Optimizer(init, update)
