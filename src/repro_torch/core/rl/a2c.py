"""A2C learner on PyTorch — the counterpart of the reference's
``core/rl/a2c.py`` (the paper's ref [24] trains A2C power managers).

The reference's update is one jitted program: a ``lax.scan`` of vmapped env
steps with auto-reset, GAE, ``jax.value_and_grad`` of the loss, gradient
clipping and AdamW. Here it is eager PyTorch on the env batch of
:mod:`repro_torch.core.rl.env`: ``n_steps`` batched env steps, autograd for
the gradients, and the reference's AdamW arithmetic
(:mod:`repro_torch.training.optimizer`). Actions are sampled on the device
from an explicit ``torch.Generator`` (Gumbel-max over the logits, as
``jax.random.categorical`` draws), so a rollout reads nothing back to the
host beyond the env's own reads.

Auto-reset: an env that finished on the previous step restarts from the
batch's reset state, which is a pure function of the constant initial
states, so it is computed once per update function and its rows are
selected with ``torch.where`` (the reference re-runs the reset every step;
the result is the same bit for bit).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import engine, sweep
from repro_torch.core.engine import EngineConst, SimState
from repro_torch.core.rl.env import (
    EnvConfig,
    EnvState,
    batched_reset,
    batched_step,
    make_env_grid,
    shard_env_batch,
    single_device,
    stack_sims,
)
from repro_torch.core.rl.networks import ActorCritic, policy_init
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training.optimizer import adamw, apply_updates, clip_by_global_norm
from repro_torch.workloads.platform import PlatformSpec
from repro_torch.workloads.workload import Workload

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    n_envs: int = 32
    n_steps: int = 16
    gamma: float = 0.99
    gae_lambda: float = 0.95
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    n_updates: int = 200
    hidden: Tuple[int, ...] = (128, 128)
    seed: int = 0


class Rollout(NamedTuple):
    obs: torch.Tensor  # [T, B, obs]
    actions: torch.Tensor  # [T, B]
    rewards: torch.Tensor  # [T, B]
    dones: torch.Tensor  # [T, B] done AFTER the step
    values: torch.Tensor  # [T, B] value at obs
    last_value: torch.Tensor  # [B]
    live: torch.Tensor  # [T, B] env was live when acting


class TrainState(NamedTuple):
    params: ActorCritic  # updated in place by each update
    opt_state: Any
    env_states: EnvState
    obs: torch.Tensor
    key: torch.Generator  # the rollout's (and PPO's shuffles') generator


def make_batched_sims(
    platform: PlatformSpec,
    workloads: Sequence[Workload],
    env_cfg: EnvConfig,
    job_capacity: Optional[int] = None,
    device: DeviceLike = None,
) -> SimState:
    """The ``[B]`` initial state of B workloads (one job capacity, the
    largest workload's unless given)."""
    dev = resolve_device(device)
    cap = job_capacity or max(len(w) for w in workloads)
    return stack_sims([
        engine.init_state(platform, w, env_cfg.engine, device=dev, job_capacity=cap)
        for w in workloads
    ])


def sample_actions(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One action a row, drawn on the device: Gumbel-max over the logits."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(F32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def collect_rollout(
    params: ActorCritic,
    env_states: EnvState,
    obs: torch.Tensor,
    key: torch.Generator,
    fresh: Tuple[EnvState, torch.Tensor],
    env_cfg: EnvConfig,
    grid,
    n_steps: int,
) -> Tuple[EnvState, torch.Tensor, Rollout]:
    """T steps of the batched env with auto-reset from ``fresh`` (the
    batch's reset state and observation); returns the data for the loss."""
    fresh_states, fresh_obs = fresh
    out = []
    with torch.no_grad():
        for _ in range(n_steps):
            need_reset = env_states.done
            env_states = EnvState(
                sweep.freeze(need_reset, fresh_states.sim, env_states.sim),
                torch.where(need_reset, fresh_states.steps, env_states.steps),
                torch.where(need_reset, fresh_states.done, env_states.done),
            )
            obs = torch.where(need_reset[:, None], fresh_obs, obs)
            logits, value = params(obs)
            action = sample_actions(logits, key)
            live = ~env_states.done
            env_states, next_obs, reward, done, _ = batched_step(
                env_cfg, grid, env_states, action
            )
            out.append((obs, action, reward, done, value, live))
            obs = next_obs
        _, last_value = params(obs)
    obs_t, act_t, rew_t, done_t, val_t, live_t = (torch.stack(x) for x in zip(*out))
    return env_states, obs, Rollout(obs_t, act_t, rew_t, done_t, val_t,
                                    last_value, live_t)


def gae(roll: Rollout, gamma: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over the [T, B] rollout."""
    adv_next = torch.zeros_like(roll.last_value)
    v_next = roll.last_value
    advs = []
    for t in reversed(range(roll.rewards.shape[0])):
        nonterm = 1.0 - roll.dones[t].to(F32)
        delta = roll.rewards[t] + gamma * v_next * nonterm - roll.values[t]
        adv_next = delta + gamma * lam * nonterm * adv_next
        v_next = roll.values[t]
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + roll.values


def _normalized(advs: torch.Tensor, mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return (advs - torch.sum(advs * mask) / n) / (
        torch.sqrt(torch.sum(torch.square(advs) * mask) / n) + 1e-6
    )


def _value_entropy(logp_all, values, returns, mask, n):
    vf = torch.sum(torch.square(values - returns) * mask) / n
    ent = -torch.sum(torch.sum(torch.exp(logp_all) * logp_all, -1) * mask) / n
    return vf, ent


def a2c_loss(params: ActorCritic, roll: Rollout, advs, returns, cfg: A2CConfig):
    logits, values = params(roll.obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, roll.actions[..., None])[..., 0]
    mask = roll.live.to(F32)
    n = torch.clamp(torch.sum(mask), min=1.0)
    adv_n = _normalized(advs, mask, n)
    pg = -torch.sum(logp * adv_n.detach() * mask) / n
    vf, ent = _value_entropy(logp_all, values, returns, mask, n)
    loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}


def _grid_and_reset(env_cfg: EnvConfig, const: EngineConst, sims0: SimState):
    grid = make_env_grid(const, sims0.t.shape[0])
    return grid, batched_reset(env_cfg, grid, sims0)


def make_update_fn(
    env_cfg: EnvConfig,
    const: EngineConst,
    sims0: SimState,
    cfg: A2CConfig,
    optimizer=None,
    devices=None,
) -> Tuple[Callable[[TrainState], Tuple[TrainState, dict]], Any]:
    """The A2C update over the env batch ``sims0`` (``[B]`` initial states
    on ``const``): returns ``(update, optimizer)``; ``update(ts)`` returns
    the next :class:`TrainState` and the metrics (device scalars)."""
    opt = optimizer or adamw(lr=cfg.lr)
    single_device(devices, env_cfg.engine)
    grid, fresh = _grid_and_reset(env_cfg, const, sims0)

    def update(ts: TrainState) -> Tuple[TrainState, dict]:
        env_states, obs, roll = collect_rollout(
            ts.params, ts.env_states, ts.obs, ts.key, fresh, env_cfg, grid,
            cfg.n_steps,
        )
        advs, returns = gae(roll, cfg.gamma, cfg.gae_lambda)
        params = list(ts.params.parameters())
        loss, aux = a2c_loss(ts.params, roll, advs, returns, cfg)
        grads = torch.autograd.grad(loss, params)
        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
        updates, opt_state = opt.update(grads, ts.opt_state, params)
        apply_updates(params, updates)
        mask = roll.live.to(F32)
        metrics = {
            "loss": loss.detach(),
            "grad_norm": gnorm,
            "mean_reward": torch.sum(roll.rewards * mask)
            / torch.clamp(torch.sum(mask), min=1.0),
            **{k: v.detach() for k, v in aux.items()},
        }
        return TrainState(ts.params, opt_state, env_states, obs, ts.key), metrics

    return update, opt


def _setup(platform, workloads, env_cfg, n_envs, seed, hidden, devices, device):
    """The shared set-up of the learners: const, the ``[n_envs]`` initial
    states (workloads repeated to fill the batch), the generator and the
    initial policy."""
    dev = resolve_device(device)
    const = engine.make_const(platform, env_cfg.engine, device=dev)
    wls = list(workloads)
    if len(wls) < n_envs:
        wls = (wls * ((n_envs + len(wls) - 1) // len(wls)))[:n_envs]
    sims0 = shard_env_batch(
        make_batched_sims(platform, wls[:n_envs], env_cfg, device=dev),
        devices, env_cfg.engine,
    )
    key = torch.Generator(device=dev).manual_seed(seed)
    params = policy_init(key, env_cfg.obs_size, env_cfg.n_actions, hidden)
    return const, sims0, key, params


def _train(update, opt, env_cfg, const, sims0, params, key, n_updates, progress):
    env_states, obs = _grid_and_reset(env_cfg, const, sims0)[1]
    ts = TrainState(params, opt.init(params.parameters()), env_states, obs, key)
    history = []
    for i in range(n_updates):
        ts, metrics = update(ts)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        if progress:
            progress(i, metrics)
    return ts.params, history


def train_a2c(
    platform: PlatformSpec,
    workloads: Sequence[Workload],
    env_cfg: EnvConfig,
    cfg: A2CConfig = A2CConfig(),
    progress: Optional[Callable[[int, dict], None]] = None,
    devices=None,
    device: DeviceLike = None,
):
    """Paper-scale A2C training on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``). Returns (params, history)."""
    const, sims0, key, params = _setup(
        platform, workloads, env_cfg, cfg.n_envs, cfg.seed, cfg.hidden,
        devices, device,
    )
    update, opt = make_update_fn(env_cfg, const, sims0, cfg, devices=devices)
    return _train(update, opt, env_cfg, const, sims0, params, key, cfg.n_updates,
                  progress)
