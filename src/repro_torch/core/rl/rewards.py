"""Reward functions (the paper's Config.py registry) on PyTorch — the
counterpart of the reference's ``core/rl/rewards.py``.

Each reward is ``r(prev_sim, new_sim, const, weights) -> f32``, computed from
accounting deltas between decision points: the energy-waste / waiting-time
trade-off the paper centers on. It takes one state or a batch of ``[B]``
rows (then ``f32[B]``, row ``b`` equal to the single state's reward bit for
bit): the ``[G, 5]`` ledger is summed group by group in a fixed order, and
the per-node watts accumulate in f64 and round to f32 once, so no sum
depends on how a device splits a reduction.
"""
from __future__ import annotations

import dataclasses
import functools
import operator

import torch

from repro_torch.core.types import ACTIVE, IDLE, SWITCHING_OFF, SWITCHING_ON

F32 = torch.float32
F64 = torch.float64
_WASTE = (IDLE, SWITCHING_ON, SWITCHING_OFF)


@dataclasses.dataclass(frozen=True)
class RewardWeights:
    w_energy: float = 1.0
    w_wait: float = 1.0


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, element by element in index order."""
    return functools.reduce(operator.add, x.unbind(-1))


def _waste_j(s) -> torch.Tensor:
    """Wasted joules: the idle and switching columns, each summed over the
    node groups."""
    e = s.energy
    return _sum_last(e[..., IDLE]) + _sum_last(e[..., SWITCHING_ON]) + _sum_last(
        e[..., SWITCHING_OFF]
    )


def _total_j(s) -> torch.Tensor:
    return _sum_last(s.energy.flatten(-2))


def _cluster_active_watts(const) -> torch.Tensor:
    """Full-cluster active draw (W), per-node on heterogeneous platforms."""
    return const.power[..., ACTIVE].sum(dim=-1, dtype=F64).to(F32)


def _d_wait(prev, new) -> torch.Tensor:
    N = new.node_state.shape[-1]
    return (new.wait_integral - prev.wait_integral) / (float(N) * 3600.0)


def waste_wait_tradeoff(prev, new, const, w: RewardWeights) -> torch.Tensor:
    """r = -(w_e * Δwasted_energy + w_w * Δaggregate_wait), energy over the
    full cluster's active draw per hour and waiting over node-hours."""
    e_scale = _cluster_active_watts(const) * 3600.0  # J per cluster-hour
    d_waste = (_waste_j(new) - _waste_j(prev)) / e_scale
    return -(w.w_energy * d_waste + w.w_wait * _d_wait(prev, new))


def group_waste_wait(prev, new, const, w: RewardWeights) -> torch.Tensor:
    """Like :func:`waste_wait_tradeoff`, but each node group's wasted energy
    is normalized by that group's own active draw before averaging."""
    G = new.energy.shape[-2]
    groups = torch.arange(G, dtype=const.group_id.dtype, device=new.t.device)
    same = const.group_id[..., None, :] == groups[:, None]  # [..., G, N]
    group_watts = torch.clamp(
        torch.where(same, const.power[..., None, :, ACTIVE], 0.0)
        .sum(dim=-1, dtype=F64).to(F32),
        min=1e-6,
    )
    d_waste_g = functools.reduce(
        operator.add,
        [new.energy[..., k] - prev.energy[..., k] for k in _WASTE],
    )
    d_waste = _sum_last(d_waste_g / (group_watts * 3600.0)) / G
    return -(w.w_energy * d_waste + w.w_wait * _d_wait(prev, new))


def energy_wait(prev, new, const, w: RewardWeights) -> torch.Tensor:
    """r = -(w_e * Δtotal_energy + w_w * Δaggregate_wait): the DVFS
    objective, which charges ACTIVE energy too."""
    e_scale = _cluster_active_watts(const) * 3600.0
    d_e = (_total_j(new) - _total_j(prev)) / e_scale
    return -(w.w_energy * d_e + w.w_wait * _d_wait(prev, new))


def energy_only(prev, new, const, w: RewardWeights) -> torch.Tensor:
    e_scale = _cluster_active_watts(const) * 3600.0
    return -(_total_j(new) - _total_j(prev)) / e_scale


def wait_only(prev, new, const, w: RewardWeights) -> torch.Tensor:
    return -_d_wait(prev, new)


REWARDS = {
    "waste_wait": waste_wait_tradeoff,
    "group_waste_wait": group_waste_wait,
    "energy_wait": energy_wait,
    "energy_only": energy_only,
    "wait_only": wait_only,
}
