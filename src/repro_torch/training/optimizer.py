"""Optimizers as pure transforms over lists of tensors — the reference's
``training/optimizer.py`` on PyTorch: ``sgd`` (with momentum),
``adamw`` (low-precision moments, a decay mask), ``adafactor``,
``cosine_schedule``, ``global_norm``, ``clip_by_global_norm`` and
``apply_updates``.

The reference's transforms take parameter pytrees; here they take lists of
tensors in one fixed order, and ``apply_updates`` adds in place. The RL
learners pass a module's ``parameters()``; LM training passes the
reference's stacked leaves (``models/convert.py`` ``reference_leaves``), so
every per-leaf decision — AdamW's decay of leaves of two or more
dimensions, Adafactor's factoring of the last two dimensions and its RMS
clip — is taken on the leaf the reference takes it on. ``lr`` is a number
or a schedule, a function of the step (an i32 tensor) returning the f32
rate, as ``cosine_schedule`` makes.

The arithmetic is the reference's op for op: f32 bias corrections ``1 -
b**step``, moments computed in f32 and stored in ``moment_dtype``, ``u =
-lr * (mu / bc1) / (sqrt(nu / bc2) + eps)``, and Adafactor's ``beta = 1 -
(step + 1) ** -decay`` with ``eps`` inside each ``rsqrt`` — which
``torch.optim`` does not keep (it rounds in another order and puts ``eps``
elsewhere).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

F32 = torch.float32

Schedule = Callable[[torch.Tensor], torch.Tensor]
LearningRate = Union[float, Schedule]


class OptState(NamedTuple):
    step: torch.Tensor  # i32
    inner: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Sequence[torch.Tensor]], OptState]
    update: Callable[..., Tuple[List[torch.Tensor], OptState]]


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


def clip_by_global_norm(tensors: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """(tensors scaled by ``min(1, max_norm / (norm + 1e-9))``, norm);
    ``norm`` defaults to :func:`global_norm` of ``tensors`` (a
    tensor-parallel rank passes the norm of the whole, unsharded set)."""
    g = global_norm(tensors) if norm is None else norm
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return [x * scale.to(x.dtype) for x in tensors], g


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Schedule:
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    down to ``min_ratio * base_lr`` at ``total_steps``."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return fn


def _lr_at(lr: LearningRate, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=F32, device=step.device)


def _step0(params: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


# ---------------------------------------------------------------------------
# SGD (+momentum)
# ---------------------------------------------------------------------------

def sgd(lr: LearningRate = 1e-2, momentum: float = 0.0) -> Optimizer:
    """``u = -lr * g``, or with momentum ``m = momentum * m + g``, ``u =
    -lr * m`` (f32 momentum)."""

    def init(params):
        params = list(params)
        m = [torch.zeros_like(p, dtype=F32) for p in params] if momentum else None
        return OptState(_step0(params), m)

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            m = [momentum * mm + g.to(F32) for mm, g in zip(state.inner, grads)]
            return [-lr_t * mm for mm in m], OptState(step, m)
        return [-lr_t * g.to(F32) for g in grads], OptState(step, None)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class _AdamMoments(NamedTuple):
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw(
    lr: LearningRate = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    moment_dtype: torch.dtype = F32,
    mask: Optional[Callable[[List[torch.Tensor]], List[bool]]] = None,
) -> Optimizer:
    """AdamW with moments stored in ``moment_dtype`` (bf16 halves them).

    ``mask(params)`` returns one bool a tensor, selecting those that decay
    (default: the tensors of two or more dimensions — norms and biases
    excluded)."""

    def decay_mask(params):
        if mask is not None:
            return list(mask(params))
        return [p.dim() >= 2 for p in params]

    def init(params):
        params = list(params)
        return OptState(
            _step0(params),
            _AdamMoments([torch.zeros_like(p, dtype=moment_dtype) for p in params],
                         [torch.zeros_like(p, dtype=moment_dtype) for p in params]),
        )

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        stepf = step.to(F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=step.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=step.device), stepf)
        if params is None:
            params, flags = [None] * len(grads), [False] * len(grads)
        else:
            params = list(params)
            flags = decay_mask(params)
        upds, mus, nus = [], [], []
        for g, mu, nu, p, dm in zip(grads, state.inner.mu, state.inner.nu, params, flags):
            g32 = g.to(F32)
            mu32 = mu.to(F32) * b1 + (1 - b1) * g32
            nu32 = nu.to(F32) * b2 + (1 - b2) * torch.square(g32)
            u = -lr_t * (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * (1.0 if dm else 0.0) * p.to(F32)
            upds.append(u)
            mus.append(mu32.to(moment_dtype))
            nus.append(nu32.to(moment_dtype))
        return upds, OptState(step, _AdamMoments(mus, nus))

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------

class _FactorState(NamedTuple):
    vr: List[torch.Tensor]  # row stats (or the full v of an unfactored leaf)
    vc: List[torch.Tensor]  # column stats (or a () placeholder)


def adafactor(
    lr: LearningRate = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    min_dim_size_to_factor: int = 128,
) -> Optimizer:
    """Adafactor (Shazeer & Stern, 2018) without momentum.

    A tensor of two or more dimensions whose last two are both at least
    ``min_dim_size_to_factor`` keeps factored row and column statistics
    over those two; every update is clipped to an RMS of
    ``clip_threshold`` over the whole tensor."""

    def factored(p):
        return p.dim() >= 2 and min(p.shape[-2:]) >= min_dim_size_to_factor

    def init(params):
        params = list(params)
        vr = [torch.zeros(p.shape[:-1], dtype=F32, device=p.device) if factored(p)
              else torch.zeros_like(p, dtype=F32) for p in params]
        vc = [torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device)
              if factored(p) else torch.zeros((), dtype=F32, device=p.device)
              for p in params]
        return OptState(_step0(params), _FactorState(vr, vc))

    def update(grads, state: OptState, params=None):
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        beta = 1.0 - (step.to(F32) + 1.0) ** (-decay)
        upds, vrs, vcs = [], [], []
        for g, vr, vc in zip(grads, state.inner.vr, state.inner.vc):
            g32 = g.to(F32)
            g2 = torch.square(g32) + eps
            if g.dim() >= 2 and vr.shape == g.shape[:-1]:
                vr = beta * vr + (1 - beta) * g2.mean(-1)
                vc = beta * vc + (1 - beta) * g2.mean(-2)
                rfac = torch.rsqrt(vr / vr.mean(-1, keepdim=True) + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g32 * rfac[..., None] * cfac[..., None, :]
            else:
                vr = beta * vr + (1 - beta) * g2
                u = g32 * torch.rsqrt(vr + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            upds.append(-lr_t * u)
            vrs.append(vr)
            vcs.append(vc)
        return upds, OptState(step, _FactorState(vrs, vcs))

    return Optimizer(init, update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}
