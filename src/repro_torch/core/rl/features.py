"""Feature extractors (the paper's Config.py registry) on PyTorch — the
counterpart of the reference's ``core/rl/features.py``.

Each extractor is ``f(sim_state, const) -> f32[feature_size]``, normalized to
roughly [0, 1] so one MLP config works across platform sizes. It takes one
state (``[N]`` node arrays, the single run's :class:`EngineConst`) or a batch
of ``[B]`` rows (the batched RL env's ``[B, N]`` state and the sweep-shaped
``[B, ...]`` tables of its :class:`~repro_torch.core.sweep.Grid`) and then
returns ``f32[B, feature_size]``, row ``b`` equal to the single state's
observation bit for bit.

The extractors read the per-node const fields (``order_key``, ``speed``,
``group_id``, ``power``) and the DVFS tables, never ``GroupTables``. Sums
of f32 values over the nodes accumulate in f64 (exact for per-group-uniform
tables, so their order does not matter on any device) and round to f32
once; counts are exact integer sums.
"""
from __future__ import annotations

import torch

from repro_torch.core import engine, sweep
from repro_torch.core.policy import forecast_pressure
from repro_torch.core.rl.actions import group_counts
from repro_torch.core.types import (
    ACTIVE,
    ALLOCATED,
    DONE,
    IDLE,
    RUNNING,
    SLEEP,
    SWITCHING_OFF,
    SWITCHING_ON,
    WAITING,
)

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32

_TIME_SCALE = 3600.0  # an hour, for log-ish time normalization
_STATES = (SLEEP, SWITCHING_ON, IDLE, ACTIVE, SWITCHING_OFF)


def _t_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.clamp(x.to(F32), min=0.0) / _TIME_SCALE)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """f32[...]: the True entries along the last axis (exact)."""
    return mask.sum(dim=-1, dtype=I32).to(F32)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = _count(mask)
    total = torch.where(mask, values, 0.0).sum(dim=-1, dtype=F64).to(F32)
    return total / torch.clamp(n, min=1.0)


def _amax(x: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """Max over the trailing ``dims`` axes (the whole table of one state or
    of each row)."""
    return x.amax(dim=tuple(range(-dims, 0)))


def _queue_window(s, W: int) -> torch.Tensor:
    if s.t.dim() == 0:
        return engine._queue_window(s, W)
    return sweep._queue_window(s, W)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` for ``[J]`` with ``[W]``, or ``[B, J]`` with ``[B, W]``."""
    return x.gather(-1, idx.long())


def hetero_features(s, const) -> torch.Tensor:
    """4-dim per-node power/speed summary: the heterogeneity spread, how
    expensive the idle pool is, how fast the sleeping and the idle pools
    are; exactly constant on homogeneous platforms."""
    key = const.order_key
    key_max = torch.clamp(key.amax(dim=-1), min=1e-6)[..., None]
    speed = const.speed
    speed_max = torch.clamp(speed.amax(dim=-1), min=1e-6)[..., None]
    idle = s.node_state == IDLE
    sleeping = s.node_state == SLEEP
    return torch.stack([
        (key.amax(dim=-1) - key.amin(dim=-1)) / key_max[..., 0],
        _masked_mean(key / key_max, idle),
        _masked_mean(speed / speed_max, sleeping),
        _masked_mean(speed / speed_max, idle),
    ], dim=-1)


def compact_features(s, const) -> torch.Tensor:
    """20-dim summary: node-state mix, queue pressure, head-job profile and
    the per-node power/speed heterogeneity summary."""
    N = s.node_state.shape[-1]
    fN = float(N)
    t = s.t[..., None]
    state_frac = [_count(s.node_state == k) / fN for k in _STATES]
    reserved_frac = _count(s.node_job >= 0) / fN

    arrived_waiting = (s.job_status == WAITING) & (s.job_subtime <= t)
    qlen = _count(arrived_waiting)
    qdemand = torch.where(arrived_waiting, s.job_res, 0).sum(dim=-1, dtype=I32).to(F32)
    alloc_cnt = _count(s.job_status == ALLOCATED)
    running = _count(s.job_status == RUNNING)

    window = _queue_window(s, 1)
    head = torch.clamp(window, min=0)
    head_valid = (window[..., 0] >= 0).to(F32)
    head_res = _take(s.job_res, head)[..., 0].to(F32) / fN * head_valid
    head_wait = _t_norm(s.t - _take(s.job_subtime, head)[..., 0]) * head_valid
    head_req = _t_norm(_take(s.job_reqtime, head)[..., 0]) * head_valid

    # next arrival proximity (anticipation signal for proactive wake-up)
    future = (s.job_status == WAITING) & (s.job_subtime > t)
    next_arr = torch.where(future, s.job_subtime, t + 2**29).amin(dim=-1)
    next_arr_gap = _t_norm(next_arr - s.t)

    remaining = _count(s.job_exists & (s.job_status != DONE))
    total = torch.clamp(_count(s.job_exists), min=1.0)

    base = torch.stack(state_frac + [
        reserved_frac,
        torch.clamp(qlen / 32.0, max=4.0),
        torch.clamp(qdemand / fN, max=4.0),
        alloc_cnt / 32.0,
        running / fN * 4.0,
        head_valid,
        head_res,
        head_wait,
        head_req,
        next_arr_gap,
        remaining / total,
    ], dim=-1)
    return torch.cat([base, hetero_features(s, const)], dim=-1)


def queue_window_features(s, const, W: int = 8) -> torch.Tensor:
    """compact_features + per-job features of the first W queued jobs."""
    base = compact_features(s, const)
    fN = float(s.node_state.shape[-1])
    window = _queue_window(s, W)
    valid = (window >= 0).to(F32)
    idx = torch.clamp(window, min=0)
    res = _take(s.job_res, idx).to(F32) / fN * valid
    wait = _t_norm(s.t[..., None] - _take(s.job_subtime, idx)) * valid
    req = _t_norm(_take(s.job_reqtime, idx)) * valid
    per_job = torch.stack([valid, res, wait, req], dim=-1).flatten(-2)
    return torch.cat([base, per_job], dim=-1)


def group_mix_features(s, const) -> torch.Tensor:
    """Per-group summary, ``f32[G * 6]``: the 5 within-group state fractions
    and the group's order-key share of the cluster maximum."""
    G = s.energy.shape[-2]
    gid = const.group_id
    fsizes = torch.clamp(
        group_counts(gid, torch.ones_like(s.node_state), G).to(F32), min=1.0
    )
    fracs = [
        group_counts(gid, (s.node_state == k).to(I32), G).to(F32) / fsizes
        for k in _STATES
    ]
    groups = torch.arange(G, dtype=gid.dtype, device=gid.device)
    same = gid[..., None, :] == groups[:, None]  # [..., G, N]
    key = const.order_key
    key_max = torch.clamp(key.amax(dim=-1), min=1e-6)[..., None]
    key_sum = torch.where(same, key[..., None, :], 0.0).sum(dim=-1, dtype=F64)
    key_g = key_sum.to(F32) / fsizes / key_max
    return torch.stack(fracs + [key_g], dim=-1).flatten(-2)


def compact_group_features(s, const) -> torch.Tensor:
    """compact_features + the per-group state-mix block."""
    return torch.cat(
        [compact_features(s, const), group_mix_features(s, const)], dim=-1
    )


def dvfs_mode_features(s, const) -> torch.Tensor:
    """Per-group current-DVFS-mode summary, ``f32[G * 3]``: the normalized
    mode index, the mode's speed over the table's largest and its watts
    over the table's largest."""
    mode = s.dvfs_mode.long()[..., None]
    span = torch.clamp(const.dvfs_n_modes.to(F32) - 1.0, min=1.0)
    idx = s.dvfs_mode.to(F32) / span
    sp = const.dvfs_speed.gather(-1, mode)[..., 0] / torch.clamp(
        _amax(const.dvfs_speed, 2), min=1e-6
    )[..., None]
    wt = const.dvfs_watts.gather(-1, mode)[..., 0] / torch.clamp(
        _amax(const.dvfs_watts, 2), min=1e-6
    )[..., None]
    return torch.stack([idx, sp, wt], dim=-1).flatten(-2)


def compact_dvfs_features(s, const) -> torch.Tensor:
    """compact_group_features + the DVFS mode block."""
    return torch.cat(
        [compact_group_features(s, const), dvfs_mode_features(s, const)], dim=-1
    )


def forecast_features(s, const) -> torch.Tensor:
    """EWMA-predictor summary, ``f32[4]``: the smoothed inter-arrival gap,
    the smoothed ask / N, the predicted extra-node pressure / N and the
    horizon."""
    fN = float(s.node_state.shape[-1])
    return torch.stack([
        _t_norm(s.fc_gap),
        torch.clamp(s.fc_res / fN, max=4.0),
        forecast_pressure(s, const).to(F32) / fN,
        _t_norm(const.forecast_horizon),
    ], dim=-1)


def compact_forecast_features(s, const) -> torch.Tensor:
    """compact_features + the forecast-predictor block."""
    return torch.cat(
        [compact_features(s, const), forecast_features(s, const)], dim=-1
    )


FEATURE_EXTRACTORS = {
    "compact": compact_features,
    "queue_window": queue_window_features,
    "compact_groups": compact_group_features,
    "compact_dvfs": compact_dvfs_features,
    "compact_forecast": compact_forecast_features,
}


def feature_size(name: str, window: int = 8, n_groups: int = 1) -> int:
    if name == "compact":
        return 20
    if name == "queue_window":
        return 20 + 4 * window
    if name == "compact_groups":
        return 20 + 6 * n_groups
    if name == "compact_dvfs":
        return 20 + 9 * n_groups
    if name == "compact_forecast":
        return 20 + 4
    raise KeyError(name)


def extract(name: str, s, const, window: int = 8) -> torch.Tensor:
    """The observation of extractor ``name`` (``window`` feeds
    ``queue_window``)."""
    fn = FEATURE_EXTRACTORS[name]
    if name == "queue_window":
        return fn(s, const, window)
    return fn(s, const)
