"""Policy and value networks on PyTorch — the counterpart of the reference's
``core/rl/networks.py``.

* ``mlp_*``: the paper-scale agent, a small MLP (``nn.Linear`` layers);
* :class:`ActorCritic` / ``policy_*``: the actor-critic with a shared tanh
  torso and two heads, the policy logits and the state value.

The reference's parameter tree ``{"torso", "pi", "v"}`` of ``{"w": [in,
out], "b": [out]}`` layers maps onto the module's ``torso.i`` / ``pi.0`` /
``v.0`` linears (``core/convert.py``: ``policy_params_from_arrays`` /
``policy_params_to_arrays``). The products are ``nn.Linear`` in f32;
PyTorch's default float32 matmul precision ("highest") keeps them out of
TF32.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils import skip_init

F32 = torch.float32


def mlp_init(generator: torch.Generator, sizes: Sequence[int]) -> nn.ModuleList:
    """``nn.Linear`` layers of ``sizes``, weights drawn from ``generator``
    (He-normal: ``N(0, 1) * sqrt(2 / fan_in)``), zero biases."""
    dev = generator.device
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        layer = skip_init(nn.Linear, fan_in, fan_out, device=dev, dtype=F32)
        with torch.no_grad():
            w = torch.randn((fan_out, fan_in), generator=generator, device=dev)
            layer.weight.copy_(w * math.sqrt(2.0 / fan_in))
            layer.bias.zero_()
        layers.append(layer)
    return nn.ModuleList(layers)


def mlp_apply(layers: nn.ModuleList, x: torch.Tensor,
              final_activation: bool = False) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if i + 1 < len(layers) or final_activation:
            x = torch.tanh(x)
    return x


class ActorCritic(nn.Module):
    """Shared tanh torso, a policy head (``n_actions`` logits) and a value
    head; ``forward(obs)`` returns ``(logits[..., n_actions], value[...])``."""

    def __init__(self, torso: nn.ModuleList, pi: nn.ModuleList, v: nn.ModuleList):
        super().__init__()
        self.torso, self.pi, self.v = torso, pi, v

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = mlp_apply(self.torso, obs, final_activation=True)
        return mlp_apply(self.pi, h), mlp_apply(self.v, h)[..., 0]


def policy_init(
    generator: torch.Generator, obs_size: int, n_actions: int,
    hidden: Sequence[int] = (128, 128),
) -> ActorCritic:
    """The actor-critic on ``generator``'s device; the heads' weights are
    zero (a uniform initial policy and a zero initial value)."""
    torso = mlp_init(generator, (obs_size, *hidden))
    pi = mlp_init(generator, (hidden[-1], n_actions))
    v = mlp_init(generator, (hidden[-1], 1))
    with torch.no_grad():
        pi[-1].weight.zero_()
        v[-1].weight.zero_()
    return ActorCritic(torso, pi, v)


def policy_apply(params: ActorCritic, obs: torch.Tensor):
    """Returns (logits[n_actions], value[])."""
    return params(obs)
