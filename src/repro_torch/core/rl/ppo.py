"""PPO learner (clipped surrogate) on PyTorch — the counterpart of the
reference's ``core/rl/ppo.py``: the A2C rollout and GAE, a different update
rule. Each epoch shuffles the ``T * B`` samples with a permutation drawn
from the train state's generator, on the device, and takes one AdamW step
a minibatch.

Sharded (``devices`` = D > 1, as ``core/rl/a2c.py``'s twin): each worker
rolls out its block and draws its own permutations from its block's
generator; each minibatch step sends the parameters to every worker, each
returns its minibatch's gradients, and the parent averages the D gradients
(``sum / D``, the reference's ``pmean`` inside ``shard_map``) before the
clip and the optimizer step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import shard
from repro_torch.core.engine import EngineConst, SimState
from repro_torch.core.rl.a2c import (
    TrainState,
    _apply,
    _grid_and_reset,
    _model_to,
    _normalized,
    _open_blocks,
    _setup,
    _train,
    _value_entropy,
    collect_rollout,
    gae,
    mean_in_order,
)
from repro_torch.core.rl.env import EnvConfig, resolve_rollout_devices
from repro_torch.device import DeviceLike
from repro_torch.training.optimizer import adamw
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


def _samples(params, roll, advs, returns):
    """The rollout's ``T * B`` samples: (obs, actions, old log-probs,
    advantages, returns, live mask)."""
    with torch.no_grad():
        logits, _ = params(roll.obs)
        old_logp = F.log_softmax(logits, dim=-1).gather(
            -1, roll.actions[..., None])[..., 0]
    return tuple(x.flatten(0, 1) for x in (
        roll.obs, roll.actions, old_logp, advs, returns, roll.live.to(F32)))


def _rollout_samples(params, roll, cfg: PPOConfig):
    """The samples and the mean reward of a rollout."""
    advs, returns = gae(roll, cfg.gamma, cfg.gae_lambda)
    mask = roll.live.to(F32)
    mean_reward = torch.sum(roll.rewards * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return _samples(params, roll, advs, returns), mean_reward


def _minibatch(params, data, perm, i: int, cfg: PPOConfig):
    """The loss and gradients of minibatch ``i`` of ``perm``."""
    mb = data[0].shape[0] // cfg.n_minibatches
    idx = perm[i * mb:(i + 1) * mb]
    loss, _ = ppo_loss(params, tuple(x[idx] for x in data), cfg)
    return loss.detach(), torch.autograd.grad(loss, list(params.parameters()))


def make_update_fn(
    env_cfg: EnvConfig,
    const: EngineConst,
    sims0: SimState,
    cfg: PPOConfig,
    optimizer=None,
    devices=None,
):
    """The PPO update over the env batch ``sims0``: returns ``(update,
    optimizer)`` as the A2C twin does, ``devices`` as there."""
    opt = optimizer or adamw(lr=cfg.lr)
    D = resolve_rollout_devices(devices, env_cfg.engine, cfg.n_envs, const.power.device)
    if D is not None:
        return _sharded_ppo(env_cfg, const, sims0, cfg, opt, D), opt
    grid, fresh = _grid_and_reset(env_cfg, const, sims0)

    def update(ts: TrainState):
        env_states, obs, roll = collect_rollout(
            ts.params, ts.env_states, ts.obs, ts.key, fresh, env_cfg, grid,
            cfg.n_steps,
        )
        data, mean_reward = _rollout_samples(ts.params, roll, cfg)
        opt_state = ts.opt_state
        losses = []
        for _ in range(cfg.n_epochs):
            perm = torch.randperm(data[0].shape[0], generator=ts.key, device=obs.device)
            for i in range(cfg.n_minibatches):
                loss, grads = _minibatch(ts.params, data, perm, i, cfg)
                opt_state, _ = _apply(opt, grads, opt_state, ts.params, cfg.max_grad_norm)
                losses.append(loss)
        metrics = {"loss": torch.stack(losses).mean(), "mean_reward": mean_reward}
        return TrainState(ts.params, opt_state, env_states, obs, ts.key), metrics

    return update, opt


def _block_rollout(blk, params, cfg: PPOConfig):
    """A worker's rollout of a sharded PPO update; keeps its samples."""
    params = params.to(shard.worker_device())
    blk.data, mean_reward = _rollout_samples(params, blk.rollout(params, cfg.n_steps),
                                             cfg)
    return mean_reward.cpu()


def _block_minibatch(blk, params, i: int, cfg: PPOConfig):
    """A worker's minibatch ``i`` of a sharded PPO update (a new permutation
    from its generator at ``i == 0``)."""
    dev = shard.worker_device()
    params = params.to(dev)
    if i == 0:
        blk.perm = torch.randperm(blk.data[0].shape[0], generator=blk.key, device=dev)
    loss, grads = _minibatch(params, blk.data, blk.perm, i, cfg)
    return shard.to_host((list(grads), loss))


def _sharded_ppo(env_cfg, const, sims0, cfg: PPOConfig, opt, D: int):
    blocks = _open_blocks(env_cfg, const, sims0, cfg.seed, D)

    def update(ts: TrainState):
        dev = next(ts.params.parameters()).device
        rewards = blocks.call(_block_rollout, _model_to(ts.params, "cpu"), cfg)
        opt_state = ts.opt_state
        losses = [[] for _ in range(D)]
        for _ in range(cfg.n_epochs):
            for i in range(cfg.n_minibatches):
                outs = blocks.call(_block_minibatch, _model_to(ts.params, "cpu"), i, cfg)
                grads = [mean_in_order(g).to(dev) for g in zip(*[o[0] for o in outs])]
                opt_state, _ = _apply(opt, grads, opt_state, ts.params, cfg.max_grad_norm)
                for d, o in enumerate(outs):
                    losses[d].append(o[1])
        metrics = {
            "loss": mean_in_order([torch.stack(x).mean() for x in losses]).to(dev),
            "mean_reward": mean_in_order(rewards).to(dev),
        }
        return TrainState(ts.params, opt_state, None, None, ts.key), metrics

    update.blocks = blocks  # the workers' blocks live as long as the update
    return update


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
    ``"cpu"``). Returns (params, history); ``devices`` as
    ``a2c.train_a2c``'s."""
    const, sims0, key, params = _setup(
        platform, workloads, env_cfg, cfg.n_envs, cfg.seed, cfg.hidden, device,
    )
    update, opt = make_update_fn(env_cfg, const, sims0, cfg, devices=devices)
    return _train(update, opt, env_cfg, const, sims0, params, key, cfg.n_updates,
                  progress)
