"""PPO learner (clipped surrogate) on PyTorch — the counterpart of the
reference's ``core/rl/ppo.py``: the A2C rollout and GAE, a different update
rule. Each epoch shuffles the ``T * B`` samples with a permutation drawn
from the train state's generator, on the device, and takes one AdamW step
a minibatch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.engine import EngineConst, SimState
from repro_torch.core.rl.a2c import (
    TrainState,
    _grid_and_reset,
    _normalized,
    _setup,
    _train,
    _value_entropy,
    collect_rollout,
    gae,
)
from repro_torch.core.rl.env import EnvConfig, single_device
from repro_torch.device import DeviceLike
from repro_torch.training.optimizer import adamw, apply_updates, clip_by_global_norm
from repro_torch.workloads.platform import PlatformSpec
from repro_torch.workloads.workload import Workload

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 32
    n_steps: int = 32
    gamma: float = 0.99
    gae_lambda: float = 0.95
    lr: float = 3e-4
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    n_epochs: int = 4
    n_minibatches: int = 4
    n_updates: int = 100
    hidden: Tuple[int, ...] = (128, 128)
    seed: int = 0


def ppo_loss(params, batch, cfg: PPOConfig):
    obs, actions, old_logp, advs, returns, mask = batch
    logits, values = params(obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, actions[..., None])[..., 0]
    n = torch.clamp(torch.sum(mask), min=1.0)
    adv_n = _normalized(advs, mask, n)
    ratio = torch.exp(logp - old_logp)
    unclipped = ratio * adv_n
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg = -torch.sum(torch.minimum(unclipped, clipped) * mask) / n
    vf, ent = _value_entropy(logp_all, values, returns, mask, n)
    loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}


def make_update_fn(
    env_cfg: EnvConfig,
    const: EngineConst,
    sims0: SimState,
    cfg: PPOConfig,
    optimizer=None,
    devices=None,
):
    """The PPO update over the env batch ``sims0``: returns ``(update,
    optimizer)`` as the A2C twin does."""
    opt = optimizer or adamw(lr=cfg.lr)
    single_device(devices, env_cfg.engine)
    grid, fresh = _grid_and_reset(env_cfg, const, sims0)

    def update(ts: TrainState):
        env_states, obs, roll = collect_rollout(
            ts.params, ts.env_states, ts.obs, ts.key, fresh, env_cfg, grid,
            cfg.n_steps,
        )
        advs, returns = gae(roll, cfg.gamma, cfg.gae_lambda)
        with torch.no_grad():
            logits, _ = ts.params(roll.obs)
            old_logp = F.log_softmax(logits, dim=-1).gather(
                -1, roll.actions[..., None])[..., 0]
        data = tuple(x.flatten(0, 1) for x in (
            roll.obs, roll.actions, old_logp, advs, returns, roll.live.to(F32)))
        n_total = data[0].shape[0]
        mb = n_total // cfg.n_minibatches
        params = list(ts.params.parameters())
        opt_state = ts.opt_state
        losses = []
        for _ in range(cfg.n_epochs):
            perm = torch.randperm(n_total, generator=ts.key, device=obs.device)
            for i in range(cfg.n_minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                loss, _ = ppo_loss(ts.params, tuple(x[idx] for x in data), cfg)
                grads = torch.autograd.grad(loss, params)
                grads, _ = clip_by_global_norm(grads, cfg.max_grad_norm)
                updates, opt_state = opt.update(grads, opt_state, params)
                apply_updates(params, updates)
                losses.append(loss.detach())
        mask = roll.live.to(F32)
        metrics = {
            "loss": torch.stack(losses).mean(),
            "mean_reward": torch.sum(roll.rewards * mask)
            / torch.clamp(torch.sum(mask), min=1.0),
        }
        return TrainState(ts.params, opt_state, env_states, obs, ts.key), metrics

    return update, opt


def train_ppo(
    platform: PlatformSpec,
    workloads: Sequence[Workload],
    env_cfg: EnvConfig,
    cfg: PPOConfig = PPOConfig(),
    progress: Optional[Callable[[int, dict], None]] = None,
    devices=None,
    device: DeviceLike = None,
):
    """PPO training on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``). Returns (params, history)."""
    const, sims0, key, params = _setup(
        platform, workloads, env_cfg, cfg.n_envs, cfg.seed, cfg.hidden,
        devices, device,
    )
    update, opt = make_update_fn(env_cfg, const, sims0, cfg, devices=devices)
    return _train(update, opt, env_cfg, const, sims0, params, key, cfg.n_updates,
                  progress)
