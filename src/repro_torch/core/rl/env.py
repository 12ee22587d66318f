"""Gym-style environment over the simulator (the paper's HPCGymEnv) on
PyTorch — the counterpart of the reference's ``core/rl/env.py``.

``env_reset`` / ``env_step`` are pure functions over :class:`EnvState` on
the single-run engine (``core/engine.py``). The reference vmaps them over a
batch of environments; here the batch is written out, as in the sweep:
:func:`batched_reset` / :func:`batched_step` step ``[B]`` rows of state on
the sweep's :class:`~repro_torch.core.sweep.Grid` (``core/sweep.py``), one
shared const laid out once as stride-0 tables (:func:`make_env_grid`), so
row ``b`` of a batched step equals the single step of that environment bit
for bit, under every engine option the single env runs (``node_order=
"pack"``, ``allocation="partition"`` and ``merge_bursts`` included). The
batched env is one device's: the learners shard an env batch over worker
processes, one per card (:func:`shard_env_batch`, :func:`rollout_mesh`,
``core/rl/a2c.py``), each worker stepping its block on these functions. The
agent acts at every simulation event, plus the periodic decision tick of
``rl_decision_interval``.

A step applies the agent's commands (rule 8, and rule 9's mode commands
under ``RLController(dvfs=True)``), runs the fused event pass (under
``fused_events=False`` the legacy ``next_time`` alone, as the reference's
env does, and the accrual gathers its own draw), accrues
energy up to the next event and runs ONE full event batch there (never the
quiet body). A row that cannot advance runs the batch at its own time. A
row that is done is frozen: every field keeps its value
(``sweep.freeze``), its reward is 0 and its step count stays. A batched
step reads the device once (the scheduler pass's windows, counted in
``engine.HOST_SYNCS``), plus, under ``allocation="partition"``, one read
of the ``[B]`` head outcomes after each step of the pass at which some row
attempts a head, and under ``merge_bursts`` one read a repeat (the repeat
condition with the next windows): each read batched over the rows, at
most as many in a pass as the row that reads most would make alone. It
launches one event kernel for the batch on a CUDA device on the fused
loop: ``event_fuse_occ`` under grouped tables, ``event_fuse_ledger`` on a
dense single-group platform without DVFS.

:class:`HPCGymEnv` is a host wrapper with the classic ``reset()`` /
``step(action)`` protocol for one environment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import engine, shard, sweep
from repro_torch.core.engine import EngineConst, SimState
from repro_torch.core.policy import (
    RLController,
    apply_dvfs,
    apply_dvfs_rows,
    apply_rl_commands,
    apply_rl_commands_rows,
)
from repro_torch.core.rl.actions import (
    ACTION_TRANSLATORS,
    DVFS_ACTIONS,
    GROUP_ACTIONS,
    action_space_size,
    full_commands,
)
from repro_torch.core.rl.features import extract, feature_size
from repro_torch.core.rl.rewards import REWARDS, RewardWeights, _total_j
from repro_torch.core.types import INF_TIME, EngineConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.workloads.platform import PlatformSpec
from repro_torch.workloads.workload import Workload

I32 = torch.int32
INF = int(INF_TIME)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    engine: EngineConfig = dataclasses.field(
        default_factory=lambda: EngineConfig(policy=RLController())
    )
    feature: str = "compact"
    action: str = "target_fraction"
    n_action_levels: int = 9
    reward: str = "waste_wait"
    reward_weights: RewardWeights = dataclasses.field(default_factory=RewardWeights)
    max_steps: int = 512
    feature_window: int = 8
    # node-group count of the platform (group-targeted actions / features
    # size the action space and observation from it)
    n_groups: int = 1

    def __post_init__(self):
        if not isinstance(self.engine.policy, RLController):
            raise ValueError(
                "EnvConfig.engine must use an RLController policy "
                "(legacy spelling: EngineConfig(psm=PSMVariant.RL))"
            )
        if self.engine.policy.controller is not None:
            raise ValueError(
                "EnvConfig.engine.policy.controller must be None: the env "
                "supplies the actions (in-graph controllers are for "
                "run_sim/launch runs)"
            )
        if (self.action in GROUP_ACTIONS) != self.engine.policy.grouped:
            raise ValueError(
                f"action {self.action!r} and RLController(grouped="
                f"{self.engine.policy.grouped}) disagree: group-targeted "
                "actions need a grouped controller and vice versa"
            )
        if (self.action in DVFS_ACTIONS) != self.engine.policy.dvfs:
            raise ValueError(
                f"action {self.action!r} and RLController(dvfs="
                f"{self.engine.policy.dvfs}) disagree: DVFS mode commands "
                "need a dvfs controller (rule 9) and vice versa"
            )

    @property
    def n_actions(self) -> int:
        return action_space_size(self.action, self.n_action_levels, self.n_groups)

    @property
    def obs_size(self) -> int:
        return feature_size(self.feature, self.feature_window, self.n_groups)


class EnvState(NamedTuple):
    sim: SimState
    steps: torch.Tensor  # i32 decision steps taken ([B] in a batch)
    done: torch.Tensor  # bool ([B] in a batch)


def _features(cfg: EnvConfig, sim: SimState, const) -> torch.Tensor:
    return extract(cfg.feature, sim, const, cfg.feature_window)


def _commands(cfg: EnvConfig, prev: SimState, const, action) -> SimState:
    on, off, mode = full_commands(
        prev,
        ACTION_TRANSLATORS[cfg.action](prev, const, action, cfg.n_action_levels),
    )
    return prev._replace(rl_on_cmd=on, rl_off_cmd=off, rl_mode_cmd=mode)


def _finish(cfg, const, state: EnvState, prev: SimState, sim: SimState,
            can_advance, all_done):
    """The step's bookkeeping, the same for one state and for rows."""
    steps = state.steps + torch.where(state.done, 0, 1).to(I32)
    done = state.done | all_done | ~can_advance | (steps >= cfg.max_steps)
    reward = torch.where(
        state.done, 0.0, REWARDS[cfg.reward](prev, sim, const, cfg.reward_weights)
    )
    obs = _features(cfg, sim, const)
    info = {"t": sim.t, "energy_j": _total_j(sim), "wait_integral": sim.wait_integral}
    return EnvState(sim, steps, done), obs, reward, done, info


def env_reset(
    cfg: EnvConfig, const: EngineConst, sim0: SimState
) -> Tuple[EnvState, torch.Tensor]:
    """Start an episode: process the t=0 batch, return the first observation."""
    sim = engine.process_batch(sim0, const, cfg.engine)
    state = EnvState(sim=sim, steps=torch.zeros_like(sim.n_batches),
                     done=engine.all_done(sim))
    return state, _features(cfg, sim, const)


def env_step(
    cfg: EnvConfig, const: EngineConst, state: EnvState, action
) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Apply the agent's power command at the current time, then advance one
    event batch. Returns (state, obs, reward, done, info); a no-op when
    done."""
    prev = state.sim
    sim = _commands(cfg, prev, const, action)
    sim = apply_rl_commands(sim, const, grouped=cfg.engine.policy.grouped)
    if cfg.engine.policy.dvfs:  # rule 9: apply the agent's mode commands now
        sim = apply_dvfs(sim, const, terminate_overrun=cfg.engine.terminate_overrun,
                         rl=True)
    nt, aux = engine.horizon(sim, const, cfg.engine)
    can_advance = (nt < INF) & ~engine.all_done(sim)
    t_next = torch.where(can_advance, nt, sim.t)
    adv = engine.accrue_energy(sim, t_next, const, aux=aux)._replace(t=t_next)
    adv = engine.process_batch(adv, const, cfg.engine)
    # a done episode keeps every field (a Kahan add of zero is no identity)
    sim = sweep.freeze(~state.done, adv, prev)
    return _finish(cfg, const, state, prev, sim, can_advance, engine.all_done(sim))


def make_env_grid(const: EngineConst, n_envs: int) -> sweep.Grid:
    """The sweep's :class:`~repro_torch.core.sweep.Grid` of ``n_envs`` rows
    sharing ``const``: every table a stride-0 view of the one const (the
    event kernels read one table at a row offset of 0), never B copies."""
    return sweep.make_grid([const] * n_envs, const.power.device)


def stack_sims(sims) -> SimState:
    """B single :class:`SimState` (one job capacity) as one ``[B]`` state."""
    return SimState(*[torch.stack(xs) for xs in zip(*sims)])


def batched_reset(cfg: EnvConfig, grid: sweep.Grid, sims0: SimState):
    """:func:`env_reset` of every row of ``sims0`` (``[B]`` state)."""
    B = sims0.t.shape[0]
    sim = sweep.process_batch(sims0, grid, cfg.engine, [True] * B, None)
    state = EnvState(sim=sim, steps=torch.zeros_like(sim.n_batches),
                     done=sweep.all_done(sim))
    return state, _features(cfg, sim, grid.const)


def batched_step(cfg: EnvConfig, grid: sweep.Grid, states: EnvState, actions):
    """:func:`env_step` of every row: ``actions`` is ``[B]``; each row equals
    its single step bit for bit."""
    prev = states.sim
    B = prev.t.shape[0]
    const = grid.const
    sim = _commands(cfg, prev, const, actions)
    pol = cfg.engine.policy
    sim = apply_rl_commands_rows(sim, const, pol.grouped, True)
    if pol.dvfs:
        sim = apply_dvfs_rows(sim, const, True, True, cfg.engine.terminate_overrun)
    nt, aux = sweep.horizon(sim, grid, cfg.engine)
    can_advance = (nt < INF) & ~sweep.all_done(sim)
    t_next = torch.where(can_advance, nt, sim.t)
    adv = sweep.accrue_energy(sim, t_next, grid, aux)._replace(t=t_next)
    adv = sweep.process_batch(adv, grid, cfg.engine, [True] * B, None)
    sim = sweep.freeze(~states.done, adv, prev)
    return _finish(cfg, const, states, prev, sim, can_advance, sweep.all_done(sim))


def resolve_rollout_devices(devices, engine_cfg: Optional[EngineConfig],
                            n_envs: int, device) -> Optional[int]:
    """The rollout device count (the reference's ``_resolve_rollout_devices``):
    ``devices`` follows the sweep's contract (None falls back to
    ``engine_cfg.devices``; an int or ``"all"``); None or 1 is unsharded
    (None), and ``n_envs`` must divide by the count."""
    D = sweep._resolve_devices(devices, engine_cfg or EngineConfig(),
                               torch.device(device))
    if D is None or D == 1:
        return None
    if n_envs % D:
        raise ValueError(
            f"n_envs={n_envs} does not shard evenly across {D} devices; "
            "size the env batch to a device multiple"
        )
    return D


def rollout_mesh(D: int, device: DeviceLike = None):
    """The D worker processes, one per card of ``device``'s type (``cuda``
    unless the caller passes ``"cpu"``), that the learners shard an env
    batch over: the reference's 1-D ``("env",)`` device mesh
    (``core/shard.py``)."""
    return shard.mesh(D, resolve_device(device))


def shard_env_batch(tree, devices=None, engine_cfg: Optional[EngineConfig] = None):
    """Cut a stacked env batch (every tensor's leading axis B) into the
    blocks of a 1-D device mesh (the reference's placement over its
    ``("env",)`` mesh): ``devices`` follows the sweep's contract (None falls
    back to ``engine_cfg.devices``, unsharded when that is None too; an int
    D or ``"all"``). Unsharded or D = 1, ``tree`` comes back as it is; else a
    tuple of D trees, block ``d`` rows ``[d B/D, (d + 1) B/D)`` (compact
    copies, each the size of its block). B must divide by D: env batches
    are caller-sized (``n_envs``), so no pad rows."""
    leaves = shard.leaves(tree)
    D = sweep._resolve_devices(devices, engine_cfg or EngineConfig(),
                               leaves[0].device)
    if D is None or D == 1:
        return tree
    B = leaves[0].shape[0]
    if B % D:
        raise ValueError(
            f"env batch of {B} does not shard evenly across {D} devices; "
            "size n_envs to a device multiple"
        )
    b = B // D
    return tuple(shard.tree_map(lambda x, d=d: x[d * b:(d + 1) * b].clone(), tree)
                 for d in range(D))


class HPCGymEnv:
    """Host wrapper for one environment (eager stepping): ``reset()`` and
    ``step(action)`` in the gym protocol, on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``)."""

    def __init__(
        self,
        platform: PlatformSpec,
        workload: Workload,
        config: Optional[EnvConfig] = None,
        job_capacity: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.cfg = config or EnvConfig()
        needs_groups = (
            self.cfg.action in GROUP_ACTIONS
            or self.cfg.action in DVFS_ACTIONS
            or self.cfg.feature in ("compact_groups", "compact_dvfs")
        )
        if needs_groups and self.cfg.n_groups != platform.n_groups():
            raise ValueError(
                f"EnvConfig.n_groups={self.cfg.n_groups} but the platform "
                f"has {platform.n_groups()} node groups; group-targeted "
                "actions/features size the action space and observation "
                "from n_groups"
            )
        if (
            self.cfg.action in DVFS_ACTIONS
            and self.cfg.n_action_levels != platform.n_dvfs_modes()
        ):
            raise ValueError(
                f"EnvConfig.n_action_levels={self.cfg.n_action_levels} but "
                f"the platform's DVFS mode-table width is "
                f"{platform.n_dvfs_modes()}; mode commands would be "
                "mis-decoded (set n_action_levels = n_dvfs_modes())"
            )
        self.platform = platform
        self.workload = workload
        self.device = resolve_device(device)
        # the queue can never exceed the job count: trim the window
        self.cfg = dataclasses.replace(
            self.cfg, engine=engine.trim_window(self.cfg.engine, len(workload))
        )
        self.const = engine.make_const(platform, self.cfg.engine, device=self.device)
        self._sim0 = engine.init_state(
            platform, workload, self.cfg.engine, device=self.device,
            job_capacity=job_capacity,
        )
        self.state: Optional[EnvState] = None

    @property
    def action_space_n(self) -> int:
        return self.cfg.n_actions

    @property
    def observation_size(self) -> int:
        return self.cfg.obs_size

    def reset(self) -> torch.Tensor:
        self.state, obs = env_reset(self.cfg, self.const, self._sim0)
        return obs

    def step(self, action) -> Tuple[torch.Tensor, float, bool, Dict]:
        self.state, obs, reward, done, info = env_step(
            self.cfg, self.const, self.state,
            torch.as_tensor(action, dtype=I32, device=self.device),
        )
        return obs, float(reward), bool(done), dict(info)
