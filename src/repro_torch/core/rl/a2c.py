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

Data-parallel rollouts (``devices`` = D > 1, the reference's ``shard_map``
over a 1-D ``("env",)`` mesh): the ``[B]`` batch is cut into D blocks
(``env.shard_env_batch``) and worker ``d`` of ``env.rollout_mesh(D)``, one
process per card, keeps block ``d``: its grid, reset state, env states
and its own ``torch.Generator``, seeded :func:`shard_seed` ``(seed, d)``
(the reference folds the mesh index into a split of its key). An update
sends the parameters to every worker; each rolls out ``n_steps`` on its
block, computes GAE, the loss and its gradients, and returns them and its
metrics on the CPU. The parent averages the gradients in worker order as
``sum / D`` (the reference's ``pmean``), clips them and applies AdamW
once, so every replica's parameters are the same by construction; the
metrics are averaged the same way (``grad_norm`` is the clip's, of the
averaged gradients). ``TrainState.env_states`` and ``obs`` are None there:
the workers hold them.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import engine, shard, sweep
from repro_torch.core.engine import EngineConst, SimState
from repro_torch.core.rl.env import (
    EnvConfig,
    EnvState,
    batched_reset,
    batched_step,
    make_env_grid,
    resolve_rollout_devices,
    rollout_mesh,
    shard_env_batch,
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


def shard_seed(seed: int, d: int) -> int:
    """The seed of block ``d``'s generator in a data-parallel rollout: the
    first 32-bit word of numpy's ``SeedSequence((seed, d))``, so each block
    draws its own actions (and PPO its own minibatches), as the reference's
    ``fold_in(split(key)[1], d)`` gives each shard its own key."""
    return int(np.random.SeedSequence((seed, d)).generate_state(1, np.uint32)[0])


def mean_in_order(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(xs[0] + xs[1] + ...) / len(xs)``, added in that order (the
    reference's ``pmean`` over the mesh)."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc / len(xs)


def _a2c_grads(params: ActorCritic, env_states, obs, key, fresh, env_cfg, grid,
               cfg: A2CConfig):
    """One block's part of an update: the rollout, GAE, the loss and its
    gradients. Returns (env states, obs, gradients, metrics)."""
    env_states, obs, roll = collect_rollout(
        params, env_states, obs, key, fresh, env_cfg, grid, cfg.n_steps)
    advs, returns = gae(roll, cfg.gamma, cfg.gae_lambda)
    loss, aux = a2c_loss(params, roll, advs, returns, cfg)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    mask = roll.live.to(F32)
    metrics = {
        "loss": loss.detach(),
        "mean_reward": torch.sum(roll.rewards * mask)
        / torch.clamp(torch.sum(mask), min=1.0),
        **{k: v.detach() for k, v in aux.items()},
    }
    return env_states, obs, grads, metrics


def _apply(opt, grads, opt_state, params: ActorCritic, max_grad_norm: float):
    """Clip ``grads`` and take one optimizer step on ``params`` in place;
    returns (optimizer state, gradient norm)."""
    params = list(params.parameters())
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    updates, opt_state = opt.update(grads, opt_state, params)
    apply_updates(params, updates)
    return opt_state, gnorm


def _a2c_metrics(metrics: dict, gnorm) -> dict:
    """The reference's metrics, in its order."""
    return {"loss": metrics["loss"], "grad_norm": gnorm,
            **{k: v for k, v in metrics.items() if k != "loss"}}


class _Block:
    """A shard worker's env block: its grid, reset state, env states and
    generator on the worker's card (``env_states`` and ``obs`` advance with
    every update; PPO keeps its rollout's samples and permutation here)."""

    def __init__(self, env_cfg: EnvConfig, const: EngineConst, sims0: SimState,
                 seed: int):
        dev = shard.worker_device()
        const, sims0 = shard.to_device((const, sims0), dev)
        self.env_cfg = env_cfg
        self.grid, self.fresh = _grid_and_reset(env_cfg, const, sims0)
        self.env_states, self.obs = self.fresh
        self.key = torch.Generator(device=dev).manual_seed(seed)
        self.data = self.perm = None

    def rollout(self, params: ActorCritic, n_steps: int) -> Rollout:
        self.env_states, self.obs, roll = collect_rollout(
            params, self.env_states, self.obs, self.key, self.fresh, self.env_cfg,
            self.grid, n_steps)
        return roll


def _model_to(params: ActorCritic, device) -> ActorCritic:
    """A copy of the policy on ``device`` (how it crosses to a worker)."""
    return copy.deepcopy(params).to(device)


def _block_a2c(blk: _Block, params: ActorCritic, cfg: A2CConfig):
    """A worker's part of a data-parallel A2C update (module docstring)."""
    params = params.to(shard.worker_device())
    blk.env_states, blk.obs, grads, metrics = _a2c_grads(
        params, blk.env_states, blk.obs, blk.key, blk.fresh, blk.env_cfg, blk.grid,
        cfg)
    return shard.to_host((list(grads), metrics))


def _open_blocks(env_cfg: EnvConfig, const: EngineConst, sims0: SimState, seed: int,
                D: int) -> shard.Resident:
    """The D blocks of ``sims0`` kept by the workers of ``rollout_mesh(D)``
    on ``const``'s device type, block ``d`` seeded ``shard_seed(seed, d)``."""
    blocks = shard_env_batch(sims0, D, env_cfg.engine)
    mesh = rollout_mesh(D, const.power.device)
    const = shard.to_host(const)
    return mesh.resident(_Block, [(env_cfg, const, shard.to_host(b), shard_seed(seed, d))
                                  for d, b in enumerate(blocks)])


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
    the next :class:`TrainState` and the metrics (device scalars).

    ``devices`` (None falls back to ``env_cfg.engine.devices``; an int D or
    ``"all"``; None and 1 run in this process) shards the batch over D
    worker processes (module docstring); B must divide by D."""
    opt = optimizer or adamw(lr=cfg.lr)
    D = resolve_rollout_devices(devices, env_cfg.engine, cfg.n_envs, const.power.device)
    if D is not None:
        return _sharded_a2c(env_cfg, const, sims0, cfg, opt, D), opt
    grid, fresh = _grid_and_reset(env_cfg, const, sims0)

    def update(ts: TrainState) -> Tuple[TrainState, dict]:
        env_states, obs, grads, metrics = _a2c_grads(
            ts.params, ts.env_states, ts.obs, ts.key, fresh, env_cfg, grid, cfg)
        opt_state, gnorm = _apply(opt, grads, ts.opt_state, ts.params, cfg.max_grad_norm)
        return (TrainState(ts.params, opt_state, env_states, obs, ts.key),
                _a2c_metrics(metrics, gnorm))

    return update, opt


def _sharded_a2c(env_cfg, const, sims0, cfg: A2CConfig, opt, D: int):
    blocks = _open_blocks(env_cfg, const, sims0, cfg.seed, D)

    def update(ts: TrainState) -> Tuple[TrainState, dict]:
        dev = next(ts.params.parameters()).device
        outs = blocks.call(_block_a2c, _model_to(ts.params, "cpu"), cfg)
        grads = [mean_in_order(g).to(dev) for g in zip(*[o[0] for o in outs])]
        metrics = {k: mean_in_order([o[1][k] for o in outs]).to(dev) for k in outs[0][1]}
        opt_state, gnorm = _apply(opt, grads, ts.opt_state, ts.params, cfg.max_grad_norm)
        return (TrainState(ts.params, opt_state, None, None, ts.key),
                _a2c_metrics(metrics, gnorm))

    update.blocks = blocks  # the workers' blocks live as long as the update
    return update


def _setup(platform, workloads, env_cfg, n_envs, seed, hidden, device):
    """The shared set-up of the learners: const, the ``[n_envs]`` initial
    states (workloads repeated to fill the batch), the generator and the
    initial policy."""
    dev = resolve_device(device)
    const = engine.make_const(platform, env_cfg.engine, device=dev)
    wls = list(workloads)
    if len(wls) < n_envs:
        wls = (wls * ((n_envs + len(wls) - 1) // len(wls)))[:n_envs]
    sims0 = make_batched_sims(platform, wls[:n_envs], env_cfg, device=dev)
    key = torch.Generator(device=dev).manual_seed(seed)
    params = policy_init(key, env_cfg.obs_size, env_cfg.n_actions, hidden)
    return const, sims0, key, params


def _train(update, opt, env_cfg, const, sims0, params, key, n_updates, progress):
    # a sharded update's workers hold the env states (``update.blocks``)
    env_states, obs = (None, None) if hasattr(update, "blocks") else (
        _grid_and_reset(env_cfg, const, sims0)[1])
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
    passes ``"cpu"``). Returns (params, history). ``devices`` shards the
    ``n_envs`` rollout batch over worker processes, one per card
    (:func:`make_update_fn`)."""
    const, sims0, key, params = _setup(
        platform, workloads, env_cfg, cfg.n_envs, cfg.seed, cfg.hidden, device,
    )
    update, opt = make_update_fn(env_cfg, const, sims0, cfg, devices=devices)
    return _train(update, opt, env_cfg, const, sims0, params, key, cfg.n_updates,
                  progress)
