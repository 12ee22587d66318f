"""Curriculum learning for the RL power manager on PyTorch — the
counterpart of the reference's ``core/rl/curriculum.py`` (paper ref [7]:
start on forgiving workloads with sparse arrivals, then raise the pressure,
keeping the policy parameters across stages).

``default_curriculum`` scales the arrival density geometrically from
``ease_factor`` x the target inter-arrival down to the target; custom
stages are a list of (GeneratorConfig, n_updates). Each stage is an A2C
phase over freshly generated workloads with a fresh optimizer state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core.rl.a2c import (
    A2CConfig,
    TrainState,
    _grid_and_reset,
    make_batched_sims,
    make_update_fn,
)
from repro_torch.core.rl.env import EnvConfig
from repro_torch.core.rl.networks import policy_init
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.workloads.generator import GeneratorConfig, generate_workload
from repro_torch.workloads.platform import PlatformSpec

Stage = Tuple[GeneratorConfig, int]  # (workload distribution, n_updates)


def default_curriculum(
    target: GeneratorConfig,
    n_stages: int = 3,
    updates_per_stage: int = 100,
    ease_factor: float = 4.0,
) -> List[Stage]:
    """Geometric arrival-density ramp ending at the target distribution."""
    stages: List[Stage] = []
    for i in range(n_stages):
        # stage 0 easiest (sparse), last stage == target
        f = ease_factor ** (1.0 - i / max(n_stages - 1, 1))
        cfg = dataclasses.replace(
            target,
            mean_interarrival=target.mean_interarrival * f,
            seed=target.seed + 1000 * i,
        )
        stages.append((cfg, updates_per_stage))
    return stages


def train_a2c_curriculum(
    platform: PlatformSpec,
    env_cfg: EnvConfig,
    stages: Sequence[Stage],
    cfg: A2CConfig = A2CConfig(),
    progress: Optional[Callable[[int, int, dict], None]] = None,
    device: DeviceLike = None,
):
    """A2C across curriculum stages on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``): the policy persists, the optimizer state and
    the environments start afresh each stage. Returns (params, history) with
    ``history[i]['stage']`` marking stages."""
    dev = resolve_device(device)
    const = engine.make_const(platform, env_cfg.engine, device=dev)
    key = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = policy_init(key, env_cfg.obs_size, env_cfg.n_actions, cfg.hidden)

    history = []
    for stage_idx, (gen_cfg, n_updates) in enumerate(stages):
        wls = [
            generate_workload(dataclasses.replace(gen_cfg, seed=gen_cfg.seed + s))
            for s in range(cfg.n_envs)
        ]
        sims0 = make_batched_sims(platform, wls, env_cfg, device=dev)
        update, opt = make_update_fn(env_cfg, const, sims0, cfg)
        env_states, obs = _grid_and_reset(env_cfg, const, sims0)[1]
        ts = TrainState(params, opt.init(params.parameters()), env_states, obs, key)
        for i in range(n_updates):
            ts, metrics = update(ts)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["stage"] = stage_idx
            history.append(metrics)
            if progress:
                progress(stage_idx, i, metrics)
    return params, history
