"""Vectorized discrete-event engine on PyTorch — the counterpart of the JAX
reference's ``core/engine.py``.

The simulation state lives in fixed-capacity tensors (:class:`SimState`) and
each step of the loop processes *one event batch*: every event sharing the
next timestamp, atomically (the reference's ``core/SEMANTICS.md``). Functions
are pure over the state — each returns a new :class:`SimState` — and carry the
reference's names, so each one's JAX counterpart is easy to find. Times are
int32 tensors (``INF_TIME = 2**30`` means never); energy is a
Kahan-compensated float32 ``[G, 5]`` group x state ledger.

What runs here: one configuration at a time, with the policy flags as
concrete Python bools (the reference's static specialization), the FCFS/EASY
scheduler under every ``node_order`` ("id", "cheap", "idle-watts", "pack")
and both ``allocation`` scopes ("any", "partition"), with or without
``merge_bursts``, on the dense per-node tables or the grouped tables
(``grouped_tables``, :mod:`repro_torch.core.tables`), and power rules 6-10
(PSUS, PSAS, PSAS+IPM, AlwaysOn; RL power commands, set by an in-graph
controller or left pending; DVFS; Forecast), on the fused loop or the
legacy one (``fused_events=False``: ``next_time`` decides each batch and
:func:`accrue_energy` re-gathers the draw, with no quiet batches and no
event kernel, the reference's baseline loop). ``devices`` is ignored, as
the reference's single run ignores it; the batched sweep over a scenario
axis is ``core/sweep.py``, which shards its rows over ``devices`` worker
processes, one per card (``core/shard.py``).

Loop structure and host syncs. The reference runs the whole simulation
inside one ``lax.while_loop`` on the device. Eager PyTorch needs a host read
for every Python ``if``/``while`` that depends on device values, so the loop
is built to read the device exactly twice per full batch and once per quiet
batch (counted in :data:`HOST_SYNCS`):

* once per batch, :func:`run_sim` reads ``(next time, all done, quiet,
  n_batches)`` together, from the fused event pass, to decide whether to
  stop and which batch body to run — the reference's ``while_loop`` cond and
  its quiet-batch ``lax.cond`` (the legacy loop reads the same values but
  ``quiet``, from :func:`next_time`; every batch of it is full);
* once per scheduler pass, :func:`_scheduler_pass` reads the queue window
  (at most ``W`` job indices), the node counts those jobs ask for and the
  number of unreserved nodes. From these the host decides the head phase
  of FCFS and EASY exactly and skips backfill attempts that cannot be
  feasible; the remaining backfill attempts keep their outcomes on the
  device (``torch.where`` gates). This replaces the reference's early-exit
  ``while_loop`` over the window and its ``lax.cond`` around the EASY
  shadow computation, attempt for attempt.

Two options add reads. Under ``allocation="partition"`` feasibility is per
group and the winning group depends on the ready-time order on the device,
so each head-phase attempt that the node count does not rule out reads its
outcome (one read per such attempt). Under ``merge_bursts`` each repeat of
the pass that attempted an allocation reads the repeat condition together
with the next pass's window (one read per repeat).

No other operation in the loop reads the device: indices are Python ints or
tensors, never 0-d tensors used as Python numbers, no boolean-mask indexing
is used, and device scalars are made by fill kernels, never copied from the
host. Capturing chunks of batches in a CUDA graph is later work.

Kernel routing (:func:`event_horizon`): on the grouped path the
per-(group, state) occupancy histogram and the next-transition min run
through ``kernels/event_fuse.py::event_fuse_occ`` (under DVFS too: the
counts are the kernel's and :func:`_group_draw` prices the ACTIVE column
at each group's mode watts); on the dense path of a single-group platform
with DVFS off the per-state power histogram and the min run through
``event_fuse_ledger`` — each the CUDA kernel on a CUDA device. The ledger
kernel knows only the base watts, so a dense DVFS run takes the per-node
route. ``EngineConfig.fused_kernel=None`` means "the kernel
on CUDA, the plain per-node route on the CPU"; ``False`` selects the
per-node route anywhere, ``True`` the kernel's wrapper anywhere (its plain
version on the CPU).

Determinism: the per-node route reduces the ``[G, 5]`` ledger with a one-hot
sum in a fixed order (no float atomics), the DVFS mode ledgers add one
value to one cell per group, and every scatter is either integer, a
scatter-min, or writes distinct indices, so a rerun on the same device is
bit-identical.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import (
    PolicyParams,
    alloc_min_speed,
    apply_dvfs,
    apply_forecast,
    apply_rl_commands,
    effective_node_speed,
    ipm_wake,
    pack_key,
    timeout_switch_off,
)
from repro_torch.core.rl.actions import full_commands
from repro_torch.core.tables import GroupTables, group_tables
from repro_torch.core.types import (
    ACTIVE,
    ALLOCATED,
    DONE,
    IDLE,
    INF_TIME,
    N_STATES,
    RUNNING,
    SLEEP,
    SWITCHING_OFF,
    SWITCHING_ON,
    WAITING,
    EngineConfig,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import event_fuse
from repro_torch.workloads.platform import PlatformSpec
from repro_torch.workloads.workload import Workload

I32 = torch.int32
F32 = torch.float32
INF = int(INF_TIME)

# host reads of device values made by the loop (run_sim, run_sim_gantt and
# the scheduler pass); a diagnostic counter, like the kernels' LAUNCHES
HOST_SYNCS = 0


class EngineConst(NamedTuple):
    """Per-run platform tables (the reference's ``EngineConst``).

    Node-indexed members are per-node tensors; a homogeneous platform's are
    broadcast views of one row. ``policy`` holds concrete Python bools.
    ``tables`` is the grouped lowering under ``grouped_tables``, else None.
    """

    power: torch.Tensor  # f32[N, 5] per-node per-state watts
    t_on: torch.Tensor  # i32[N] switch-on delay (s)
    t_off: torch.Tensor  # i32[N] switch-off delay (s)
    speed: torch.Tensor  # f32[N] compute speed (realized runtime = work/speed)
    order_key: torch.Tensor  # f32[N] allocation preference (lower first)
    group_id: torch.Tensor  # i32[N] node-group index
    timeout: torch.Tensor  # i32 idle-timeout (s); INF_TIME = never
    rl_interval: torch.Tensor  # i32 RL decision tick; INF_TIME = never
    policy: PolicyParams  # concrete bool flags
    dvfs_speed: torch.Tensor  # f32[G, M] node speed in mode m
    dvfs_watts: torch.Tensor  # f32[G, M] ACTIVE-state watts in mode m
    dvfs_n_modes: torch.Tensor  # i32[G] live modes per group
    forecast_horizon: torch.Tensor  # i32 look-ahead seconds
    forecast_alpha: torch.Tensor  # f32 EWMA smoothing weight
    tables: Optional[GroupTables] = None


class SimState(NamedTuple):
    """The simulation state (the reference's ``SimState``, field for field)."""

    t: torch.Tensor  # i32 scalar
    # nodes
    node_state: torch.Tensor  # i32[N]
    node_until: torch.Tensor  # i32[N] transition completion (INF otherwise)
    node_job: torch.Tensor  # i32[N] allocated job (-1 = unreserved)
    node_idle_since: torch.Tensor  # i32[N]
    # jobs (submission order)
    job_res: torch.Tensor  # i32[J]
    job_subtime: torch.Tensor  # i32[J]
    job_reqtime: torch.Tensor  # i32[J]
    job_run: torch.Tensor  # i32[J] nominal runtime (work at speed 1)
    job_eff: torch.Tensor  # i32[J] effective runtime
    job_status: torch.Tensor  # i32[J]
    job_start: torch.Tensor  # i32[J] (-1 until started)
    job_finish: torch.Tensor  # i32[J] (INF until started)
    job_alloc_ready: torch.Tensor  # i32[J] predicted start at allocation
    job_exists: torch.Tensor  # bool[J] (False for padding)
    job_terminated: torch.Tensor  # bool[J]
    # accounting (Kahan-compensated f32 per node group x state)
    energy: torch.Tensor  # f32[G, 5]
    energy_c: torch.Tensor  # f32[G, 5]
    wait_integral: torch.Tensor  # f32: integral of #(arrived, not started) dt
    wait_c: torch.Tensor  # Kahan compensation
    # counters
    n_batches: torch.Tensor
    n_allocs: torch.Tensor
    n_starts: torch.Tensor
    n_completions: torch.Tensor
    n_switch_on: torch.Tensor
    n_switch_off: torch.Tensor
    # rule 8-10 state: pending RL commands, DVFS modes and mode ledgers,
    # each job's realized speed (set at its start, rescaled by rule 9)
    rl_on_cmd: torch.Tensor  # i32[G]
    rl_off_cmd: torch.Tensor  # i32[G]
    dvfs_mode: torch.Tensor  # i32[G]
    rl_mode_cmd: torch.Tensor  # i32[G]
    job_speed: torch.Tensor  # f32[J]
    mode_time: torch.Tensor  # f32[G, M]
    mode_energy: torch.Tensor  # f32[G, M]
    truncated: torch.Tensor  # bool: the batch cap stopped the run
    occ: torch.Tensor  # i32[G, 5] occupancy (set by the grouped path only)
    fc_gap: torch.Tensor  # f32
    fc_res: torch.Tensor  # f32
    fc_last_arr: torch.Tensor  # i32
    fc_prev_t: torch.Tensor  # i32


class GanttLog(NamedTuple):
    t0: torch.Tensor  # i32[n]
    t1: torch.Tensor  # i32[n]
    state: torch.Tensor  # i32[n, N]
    job: torch.Tensor  # i32[n, N]
    n: int  # rows used


# ---------------------------------------------------------------------------
# what this slice runs
# ---------------------------------------------------------------------------

def check_supported(config: EngineConfig) -> None:
    """The single run takes every configuration: this check refuses none.

    ``devices`` places a sweep's scenario axis, or a learner's env batch,
    over worker processes (``core/shard.py``) and is ignored here, as the
    reference's ``simulate`` ignores it (the field enters only its jit
    key)."""
    del config


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def make_const(
    platform: PlatformSpec, config: EngineConfig, device: DeviceLike = None
) -> EngineConst:
    """Lower (platform, config) to the engine's tables on ``device``
    (``cuda`` unless the caller passes ``"cpu"``)."""
    check_supported(config)
    dev = resolve_device(device)
    N = platform.nb_nodes
    if platform.node_groups:
        power = _t(platform.node_power_table(), F32, dev)
        t_on = _t(platform.node_t_switch_on(), I32, dev)
        t_off = _t(platform.node_t_switch_off(), I32, dev)
        speed = _t(platform.node_speed(), F32, dev)
        if config.node_order == "idle-watts":
            order_key = power[:, IDLE]
        elif config.node_order == "pack":
            # the pack key is per-pass state (policy.pack_key); unused here
            order_key = torch.zeros(N, dtype=F32, device=dev)
        else:
            order_key = _t(platform.node_order_key(), F32, dev)
        group_id = _t(platform.node_group_id(), I32, dev)
    else:
        # homogeneous: broadcast views of the scalars (no N-sized copies)
        power = _t(platform.power_table(), F32, dev).expand(N, N_STATES)
        t_on = _t(platform.t_switch_on, I32, dev).expand(N)
        t_off = _t(platform.t_switch_off, I32, dev).expand(N)
        speed = _t(platform.speed(), F32, dev).expand(N)
        if config.node_order == "idle-watts":
            key = np.float32(platform.power_idle)
        elif config.node_order == "pack":
            key = np.float32(0.0)  # per-pass state, as above
        else:
            # same f32 expression as PlatformSpec.node_order_key()
            key = np.float32(platform.power_active) / np.float32(
                platform.speed()
            )
        order_key = _t(key, F32, dev).expand(N)
        group_id = torch.zeros(N, dtype=I32, device=dev)
    dvfs_speed, dvfs_watts, dvfs_n = platform.group_dvfs_tables()
    horizon = config.forecast_horizon
    if horizon is None:
        horizon = getattr(config.policy, "horizon", None) or 0
    alpha = getattr(config.policy, "alpha", None)
    if alpha is None:
        alpha = config.forecast_alpha
    return EngineConst(
        power=power,
        t_on=t_on,
        t_off=t_off,
        speed=speed,
        order_key=order_key,
        group_id=group_id,
        timeout=_t(config.timeout_or_inf, I32, dev),
        rl_interval=_t(config.rl_decision_interval or INF, I32, dev),
        policy=config.policy.params(config.base).static(),
        dvfs_speed=_t(dvfs_speed, F32, dev),
        dvfs_watts=_t(dvfs_watts, F32, dev),
        dvfs_n_modes=_t(dvfs_n, I32, dev),
        forecast_horizon=_t(int(horizon), I32, dev),
        forecast_alpha=_t(float(alpha), F32, dev),
        tables=(
            group_tables(platform, config, device=dev)
            if config.grouped_tables else None
        ),
    )


def init_state(
    platform: PlatformSpec,
    workload: Workload,
    config: EngineConfig,
    device: DeviceLike = None,
    job_capacity: Optional[int] = None,
    start_state: int = IDLE,
) -> SimState:
    """Build the initial SimState on ``device`` (host arrays, one copy)."""
    dev = resolve_device(device)
    arrs = workload.arrays()
    n = len(arrs["res"])
    J = job_capacity or n
    if J < n:
        raise ValueError(f"job_capacity {J} < {n} jobs")
    N = platform.nb_nodes

    def pad(x, fill):
        out = np.full(J, fill, np.int32)
        out[:n] = x
        return out

    res = pad(arrs["res"], 1)
    subtime = pad(arrs["subtime"], INF)
    reqtime = pad(arrs["reqtime"], 1)
    runtime = pad(arrs["runtime"], 1)
    status = np.full(J, WAITING, np.int32)
    status[n:] = DONE
    exists = np.zeros(J, bool)
    exists[:n] = True
    G = platform.n_groups()
    M = platform.n_dvfs_modes()
    occ0 = np.zeros((G, N_STATES), np.int32)
    occ0[:, start_state] = np.bincount(
        platform.node_group_id(), minlength=G
    ).astype(np.int32)

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    def scalar(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    return SimState(
        t=scalar(0, I32),
        node_state=full((N,), start_state, I32),
        node_until=full((N,), INF, I32),
        node_job=full((N,), -1, I32),
        node_idle_since=full((N,), 0, I32),
        job_res=_t(res, I32, dev),
        job_subtime=_t(subtime, I32, dev),
        job_reqtime=_t(reqtime, I32, dev),
        job_run=_t(runtime, I32, dev),
        job_eff=_t(runtime, I32, dev),
        job_status=_t(status, I32, dev),
        job_start=full((J,), -1, I32),
        job_finish=full((J,), INF, I32),
        job_alloc_ready=full((J,), INF, I32),
        job_exists=_t(exists, torch.bool, dev),
        job_terminated=full((J,), False, torch.bool),
        energy=full((G, N_STATES), 0.0, F32),
        energy_c=full((G, N_STATES), 0.0, F32),
        wait_integral=scalar(0.0, F32),
        wait_c=scalar(0.0, F32),
        n_batches=scalar(0, I32),
        n_allocs=scalar(0, I32),
        n_starts=scalar(0, I32),
        n_completions=scalar(0, I32),
        n_switch_on=scalar(0, I32),
        n_switch_off=scalar(0, I32),
        rl_on_cmd=full((G,), 0, I32),
        rl_off_cmd=full((G,), 0, I32),
        dvfs_mode=full((G,), 0, I32),
        rl_mode_cmd=full((G,), -1, I32),
        job_speed=full((J,), 1.0, F32),
        mode_time=full((G, M), 0.0, F32),
        mode_energy=full((G, M), 0.0, F32),
        truncated=scalar(False, torch.bool),
        occ=_t(occ0, I32, dev),
        fc_gap=scalar(float(INF), F32),
        fc_res=scalar(0.0, F32),
        fc_last_arr=scalar(0, I32),
        fc_prev_t=scalar(-1, I32),
    )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _clamp_job(idx: torch.Tensor) -> torch.Tensor:
    """int64 job index of each node, -1 (unreserved) clamped to 0."""
    return torch.clamp(idx, min=0).long()


def _ready_times(s: SimState, const: EngineConst) -> torch.Tensor:
    """Policy-dependent node ready times (SEMANTICS.md table); INF for ACTIVE."""
    st = s.node_state
    if const.policy.eager_ready:
        return torch.where(st == ACTIVE, INF, s.t.expand_as(st))
    ready = torch.full_like(st, INF)
    ready = torch.where(st == SWITCHING_OFF, s.node_until + const.t_on, ready)
    ready = torch.where(st == SLEEP, s.t + const.t_on, ready)
    ready = torch.where(st == SWITCHING_ON, s.node_until, ready)
    return torch.where(st == IDLE, s.t, ready)


def _occupancy(s: SimState, const: EngineConst) -> torch.Tensor:
    """i32[G, 5] per-(group, state) node histogram — the grouped path's one
    O(N) reduction (the plain route of ``event_fuse_occ``). An int32
    ``index_add_`` is exact in any order, so it is deterministic on CUDA."""
    G = s.energy.shape[0]
    cell = (const.group_id * N_STATES + s.node_state).long()
    return torch.zeros(G * N_STATES, dtype=I32, device=cell.device).index_add_(
        0, cell, torch.ones_like(s.node_state)
    ).view(G, N_STATES)


def _group_draw(s: SimState, occ: torch.Tensor, const: EngineConst) -> torch.Tensor:
    """f32[G, 5] instantaneous draw from the occupancy histogram: ``occ *
    power``, with the ACTIVE column priced at each group's current DVFS mode
    watts under rule 9 — the grouped spelling of :func:`_node_power_draw`."""
    draw = occ.to(F32) * const.tables.power
    if const.policy.dvfs_enabled:
        mode_w = const.dvfs_watts.gather(1, s.dvfs_mode.long()[:, None])[:, 0]
        draw[:, ACTIVE] = occ[:, ACTIVE].to(F32) * mode_w
    return draw


def _kahan_add(energy, comp, delta):
    y = delta - comp
    t = energy + y
    comp = (t - energy) - y
    return t, comp


def _read(*values: torch.Tensor) -> List[int]:
    """One host read of several device values, flattened and concatenated
    into one list of Python ints (counted in HOST_SYNCS)."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return torch.cat([v.reshape(-1).to(I32) for v in values]).tolist()


# ---------------------------------------------------------------------------
# event-batch phases (SEMANTICS.md rules 1..7)
# ---------------------------------------------------------------------------

def _complete_jobs(s: SimState) -> SimState:
    done_now = (s.job_status == RUNNING) & (s.job_finish <= s.t)
    nj = s.node_job
    node_of_done = (nj >= 0) & done_now[_clamp_job(nj)]
    return s._replace(
        job_status=torch.where(done_now, DONE, s.job_status),
        node_job=torch.where(node_of_done, -1, nj),
        node_state=torch.where(node_of_done, IDLE, s.node_state),
        node_until=torch.where(node_of_done, INF, s.node_until),
        node_idle_since=torch.where(node_of_done, s.t, s.node_idle_since),
        n_completions=s.n_completions + done_now.sum(dtype=I32),
    )


def _complete_transitions(s: SimState, const: EngineConst) -> SimState:
    on_done = (s.node_state == SWITCHING_ON) & (s.node_until <= s.t)
    off_done = (s.node_state == SWITCHING_OFF) & (s.node_until <= s.t)
    chain = off_done & (s.node_job >= 0)  # reserved while shutting down
    node_state = torch.where(on_done, IDLE, s.node_state)
    node_state = torch.where(off_done, SLEEP, node_state)
    node_state = torch.where(chain, SWITCHING_ON, node_state)
    node_until = torch.where(on_done | off_done, INF, s.node_until)
    node_until = torch.where(chain, s.t + const.t_on, node_until)
    return s._replace(
        node_state=node_state,
        node_until=node_until,
        node_idle_since=torch.where(on_done, s.t, s.node_idle_since),
    )


def _queue_window(s: SimState, W: int) -> torch.Tensor:
    """i32[W]: indices of the first W WAITING-and-arrived jobs; -1 padding.

    Jobs outside the window all scatter into the extra slot ``W`` of a
    ``W + 1`` buffer, which is dropped, so the duplicate writes never reach
    a kept slot."""
    waiting = (s.job_status == WAITING) & (s.job_subtime <= s.t)
    rank = torch.cumsum(waiting, 0, dtype=I32) - 1  # rank among waiting jobs
    J = s.job_status.shape[0]
    dest = torch.where(waiting & (rank < W), rank, W)
    window = torch.full((W + 1,), -1, dtype=I32, device=dest.device)
    window.scatter_(
        0, dest.long(), torch.arange(J, dtype=I32, device=dest.device)
    )
    return window[:W]


class PassInputs(NamedTuple):
    """Allocation inputs computed once per scheduler pass (the reference's
    ``pass_inputs``); they are loop-invariant for every node an attempt reads
    (an unreserved node): an allocation only reserves nodes, or wakes SLEEP
    -> SWITCHING_ON with ``until = t + t_on``, whose transition-aware ready
    time ``t + t_on`` is the one it had asleep."""

    ready: Optional[torch.Tensor]  # i32[N] ready times; None on the grouped
    # path under an eager policy (every eligible node is ready at t)
    order: Optional[torch.Tensor]  # i64[N] allocation order (grouped only)
    okey: Optional[torch.Tensor]  # f32[N] pack key (node_order="pack" only)


def _pass_inputs(s: SimState, const: EngineConst, cfg: EngineConfig) -> PassInputs:
    """Hoist the allocation inputs of one scheduler pass. On the grouped
    path the node order is ``tables.perm`` (or the stable order of the pack
    key), stably re-sorted by ready time unless the policy is eager — one
    sort per pass, or none, instead of two per attempt."""
    okey = pack_key(s, const) if cfg.node_order == "pack" else None
    if not cfg.grouped_tables:
        return PassInputs(_ready_times(s, const), None, okey)
    if okey is not None:
        base = torch.argsort(okey, stable=True)
    else:
        base = const.tables.perm.long()
    if const.policy.eager_ready:
        return PassInputs(None, base, okey)
    ready = _ready_times(s, const)
    return PassInputs(ready, base[torch.argsort(ready[base], stable=True)], okey)


def _partition_pick(es, gid, res_j, n_groups: int):
    """Per-group masked-cumsum pick (``allocation="partition"``): ``es`` and
    ``gid`` are node eligibility and group id in allocation order. A group
    is feasible iff it has ``res_j`` eligible nodes; the winner is the group
    whose ``res_j``-th eligible node comes earliest in the order (positions
    are distinct nodes, so there are no ties). Returns the in-order selection
    mask and the any-group-fits predicate. Oracle twin:
    ``PyDES._partition_select``."""
    N = es.shape[0]
    groups = torch.arange(n_groups, dtype=gid.dtype, device=gid.device)
    onehot = (gid[None, :] == groups[:, None]) & es[None, :]
    csum = torch.cumsum(onehot, dim=1, dtype=I32)  # [G, N] running counts
    feasible_g = csum[:, -1] >= res_j
    # argmax/argmin take no bools and return the first extremum, as in JAX
    pos = torch.argmax((csum >= res_j).to(I32), dim=1)
    best = torch.argmin(torch.where(feasible_g, pos, N)).view(1)
    feasible = feasible_g.any()
    sel = (
        onehot.index_select(0, best)[0]
        & (csum.index_select(0, best)[0] <= res_j)
        & feasible
    )
    return sel, feasible


def _try_allocate(s, const, cfg, j: int, inputs: PassInputs,
                  shadow=None, extra=None):
    """Attempt to allocate job ``j`` (a Python int). Returns (ok, new_state);
    a failed attempt returns a state equal to ``s``.

    ``shadow``/``extra`` (device scalars) impose the EASY backfill test;
    None means head phase (no backfill constraint). ``inputs`` are the
    pass-hoisted :class:`PassInputs`.

    Dense path (SEMANTICS.md §Heterogeneity): nodes are taken by ``(ready,
    order_key, nid)`` with stable argsorts; ``node_order == "id"`` drops the
    ``order_key`` term, and ``"pack"`` uses the pass's pack key. Grouped
    path: the first ``res_j`` eligible nodes of the hoisted order, by a
    masked cumsum — the same nodes, because a stable sort keeps the relative
    order of the eligible nodes, whose keys are frozen within the pass.
    Under ``allocation="partition"`` the nodes come from one group
    (:func:`_partition_pick`), and the attempt fails when no group fits.
    """
    eligible = s.node_job < 0
    res_j = s.job_res[j]
    N = eligible.shape[0]
    G = s.energy.shape[0]
    partition = cfg.allocation == "partition"
    if inputs.order is not None:
        order = inputs.order
        es = eligible[order]
        if partition:
            sel_sorted, ok = _partition_pick(es, const.group_id[order], res_j, G)
        else:
            sel_sorted = es & (torch.cumsum(es, 0, dtype=I32) <= res_j)
            ok = eligible.sum(dtype=I32) >= res_j
        if inputs.ready is None:  # eager policy: chosen nodes are ready now
            ready_max = s.t
        else:
            ready_max = torch.where(sel_sorted, inputs.ready[order], -1).amax()
    else:
        key = torch.where(eligible, inputs.ready, INF)
        if cfg.node_order != "id":
            # lexicographic (ready, order_key, nid): stable argsort by the
            # secondary key first, then by ready over that permutation
            k2 = const.order_key if inputs.okey is None else inputs.okey
            perm1 = torch.argsort(
                torch.where(eligible, k2, float("inf")), stable=True
            )
            order = perm1[torch.argsort(key[perm1], stable=True)]
        else:
            order = torch.argsort(key, stable=True)  # ties -> lowest node id
        if partition:
            sel_sorted, ok = _partition_pick(
                eligible[order], const.group_id[order], res_j, G
            )
        else:
            sel_sorted = torch.arange(N, device=key.device, dtype=I32) < res_j
            ok = eligible.sum(dtype=I32) >= res_j  # feasible
        ready_max = torch.where(sel_sorted, key[order], -1).amax()
    if shadow is not None:
        pred_completion = ready_max + s.job_reqtime[j]
        ok = ok & ((pred_completion <= shadow) | (res_j <= extra))
    # order is a permutation: the scatter writes every node once
    chosen = torch.empty_like(eligible).scatter_(0, order, sel_sorted)
    chosen = chosen & eligible & ok
    # reserve + auto-wake chosen sleeping nodes
    wake = chosen & (s.node_state == SLEEP)
    job_status = s.job_status.clone()
    job_status[j] = torch.where(ok, ALLOCATED, job_status[j])
    job_alloc_ready = s.job_alloc_ready.clone()
    job_alloc_ready[j] = torch.where(ok, ready_max, job_alloc_ready[j])
    new = s._replace(
        node_job=torch.where(chosen, j, s.node_job),
        node_state=torch.where(wake, SWITCHING_ON, s.node_state),
        node_until=torch.where(wake, s.t + const.t_on, s.node_until),
        job_status=job_status,
        job_alloc_ready=job_alloc_ready,
        n_allocs=s.n_allocs + ok.to(I32),
        n_switch_on=s.n_switch_on + wake.sum(dtype=I32),
    )
    return ok, new


def _shadow(s: SimState, head: int, ready):
    """EASY shadow time S and extra count E for the blocked head job
    (``ready``: the pass-hoisted ready times)."""
    nj = s.node_job
    cj = _clamp_job(nj)
    status = s.job_status[cj]
    reqtime = s.job_reqtime[cj]
    pred_of_job = torch.where(
        status == RUNNING,
        s.job_start[cj] + reqtime,
        torch.where(status == ALLOCATED, s.job_alloc_ready[cj] + reqtime, s.t),
    )
    rel = torch.where(nj >= 0, pred_of_job, ready)
    # spars-lint: ignore[PL005] values only: equal values sort to the same list
    rel_sorted = torch.sort(rel).values
    res_h = s.job_res[head]
    # an unsatisfiable request (res > N) reads the last entry, like the
    # reference's clamped out-of-bounds gather
    idx = torch.clamp(res_h - 1, 0, rel.shape[0] - 1)
    S = rel_sorted.gather(0, idx.long().view(1)).view(())
    E = (rel <= S).sum(dtype=I32) - res_h
    return S, E


def _window_values(s: SimState, W: int):
    """The device values a scheduler pass reads: the queue window (live
    slots packed first), the node counts its jobs ask for, and the number of
    unreserved nodes."""
    window = _queue_window(s, W)
    return window, s.job_res[_clamp_job(window)], (s.node_job < 0).sum(dtype=I32)


def _run_pass(s: SimState, const: EngineConst, cfg: EngineConfig, host):
    """One scheduler pass over the window read into ``host``. Returns
    (state, whether any allocation was attempted)."""
    W = cfg.window
    jobs = [(j, r) for j, r in zip(host[:W], host[W:2 * W]) if j >= 0]
    n_free = host[2 * W]
    if all(r > n_free for _, r in jobs):  # nothing can be allocated
        return s, False
    inputs = _pass_inputs(s, const, cfg)
    partition = cfg.allocation == "partition"
    for k, (j, res_j) in enumerate(jobs):
        if res_j <= n_free:
            # head phase: under "any" a job that fits the unreserved nodes
            # is allocated; under "partition" the outcome is read
            ok, s = _try_allocate(s, const, cfg, j, inputs)
            if not partition or _read(ok)[0]:
                n_free -= res_j
                continue
        if not const.policy.backfill:  # FCFS: stop at the first blocked head
            return s, True
        ready = inputs.ready if inputs.ready is not None else _ready_times(s, const)
        shadow, extra = _shadow(s, j, ready)
        for b, res_b in jobs[k + 1:]:
            if res_b > n_free:  # infeasible whatever the backfill test says
                continue
            ok, s = _try_allocate(s, const, cfg, b, inputs, shadow, extra)
            # backfill consumed part of the extra pool
            extra = torch.where(ok, extra - res_b, extra)
        return s, True
    return s, True


def _scheduler_pass(s: SimState, const: EngineConst, cfg: EngineConfig) -> SimState:
    """Rule 4: FCFS (stop at the first blocked head) or EASY backfilling.

    One host read per pass fetches the queue window, the node counts the
    window's jobs ask for, and the number of unreserved nodes. That decides
    the head phase on the host: under ``allocation="any"`` a head-phase
    attempt succeeds exactly when the job asks for no more than the
    unreserved nodes (there is no backfill test yet), and then reserves
    exactly that many. So heads that fit are allocated, and at the first
    head that does not fit FCFS stops; EASY computes the shadow time S and
    extra pool E once, from that state, and tries every later job under the
    backfill test, with the outcomes staying on the device. A later job
    that asks for more nodes than were unreserved when the head blocked
    cannot be feasible (the count only shrinks within the pass), so it is
    not attempted. This is the reference's early-exit scan, attempt for
    attempt: a skipped attempt is one whose outcome is known to be a
    failure, which changes nothing. Under ``allocation="partition"`` the
    node count is a necessary condition only, so each head attempt it
    allows reads its outcome.

    Burst merging (``cfg.merge_bursts``): the pass repeats at the same
    timestamp while it allocates and arrived jobs are still WAITING, so a
    burst wider than the window drains in one batch. The repeat condition is
    read together with the next pass's window.
    """
    W = cfg.window
    host = _read(*_window_values(s, W))
    while True:
        before = s.n_allocs
        s, attempted = _run_pass(s, const, cfg, host)
        if not (cfg.merge_bursts and attempted):
            return s
        more = (s.n_allocs > before) & (
            (s.job_status == WAITING) & (s.job_subtime <= s.t)
        ).any()
        more_h, *host = _read(more, *_window_values(s, W))
        if not more_h:
            return s


def _start_jobs(s: SimState, const: EngineConst, cfg: EngineConfig) -> SimState:
    J = s.job_status.shape[0]
    nj = s.node_job
    cj = _clamp_job(nj)
    contrib = ((s.node_state == IDLE) & (nj >= 0)).to(I32)
    ready_count = torch.zeros(J, dtype=I32, device=nj.device).index_add_(
        0, cj, contrib
    )
    start = (s.job_status == ALLOCATED) & (ready_count == s.job_res)
    node_starts = (nj >= 0) & start[cj]
    # realized wall time = nominal work / slowest allocated node; the f32
    # ceil is the cross-engine contract (SEMANTICS.md §Heterogeneity)
    node_speed = effective_node_speed(
        const, s.dvfs_mode, const.policy.dvfs_enabled
    )
    speed_min = alloc_min_speed(nj, node_speed, J)
    speed_min = torch.where(start, speed_min, 1.0)
    realized = torch.clamp(
        torch.ceil(s.job_run.to(F32) / speed_min).to(I32), min=1
    )
    if cfg.terminate_overrun:
        eff = torch.minimum(realized, s.job_reqtime)
        term = realized > s.job_reqtime
    else:
        eff = realized
        term = torch.zeros_like(start)
    return s._replace(
        job_status=torch.where(start, RUNNING, s.job_status),
        job_start=torch.where(start, s.t, s.job_start),
        job_eff=torch.where(start, eff, s.job_eff),
        job_speed=torch.where(start, speed_min, s.job_speed),
        job_terminated=torch.where(start, term, s.job_terminated),
        job_finish=torch.where(start, s.t + eff, s.job_finish),
        node_state=torch.where(node_starts, ACTIVE, s.node_state),
        node_until=torch.where(node_starts, INF, s.node_until),
        n_starts=s.n_starts + start.sum(dtype=I32),
    )


def _power_step(s: SimState, const: EngineConst, cfg: EngineConfig) -> SimState:
    """Rules 6-10 by the concrete policy flags, in the reference's order:
    rule 6, rule 7, the in-graph controller, rules 8, 9 and 10.

    The controller (``RLController.controller``, ``f(s, const) -> (on, off)``
    or ``(on, off, mode)``) runs on every batch (a controller turns quiet
    batching off) and sets the pending command vectors, which rules 8-9
    then apply; without one, commands set on the state beforehand are
    applied."""
    pp = const.policy
    if pp.sleep_enabled:
        s = timeout_switch_off(s, const, ipm_cap=pp.ipm_enabled)
    if pp.ipm_enabled:
        s = ipm_wake(s, const)
    controller = getattr(cfg.policy, "controller", None)
    if controller is not None:
        out = controller(s, const)
        if getattr(cfg.policy, "dvfs", False) and len(out) < 3:
            # a pair under RL:dvfs would pin every group at mode 0 (dvfs_rl
            # bypasses the ladder): fail instead
            raise ValueError(
                "RLController(dvfs=True) needs a controller returning "
                "(on, off, mode) — this one returns only (on, off), so no "
                "mode command would ever be issued"
            )
        on, off, mode = full_commands(s, out)
        dev = s.t.device
        s = s._replace(**{
            name: torch.broadcast_to(
                torch.as_tensor(x, device=dev), like.shape
            ).to(I32)
            for name, x, like in (("rl_on_cmd", on, s.rl_on_cmd),
                                  ("rl_off_cmd", off, s.rl_off_cmd),
                                  ("rl_mode_cmd", mode, s.rl_mode_cmd))
        })
    if pp.rl_enabled:
        s = apply_rl_commands(s, const, grouped=pp.rl_grouped)
    if pp.dvfs_enabled:
        s = apply_dvfs(s, const, terminate_overrun=cfg.terminate_overrun,
                       rl=pp.dvfs_rl)
    if pp.forecast_enabled:
        s = apply_forecast(s, const, terminate_overrun=cfg.terminate_overrun,
                           dvfs_ramp=pp.forecast_dvfs)
    return s


def process_batch(s: SimState, const: EngineConst, cfg: EngineConfig) -> SimState:
    """One atomic event batch at time s.t (SEMANTICS.md rules 1-10)."""
    s = _complete_jobs(s)
    s = _complete_transitions(s, const)
    s = _scheduler_pass(s, const, cfg)
    s = _start_jobs(s, const, cfg)
    s = _power_step(s, const, cfg)
    return s._replace(n_batches=s.n_batches + 1)


# ---------------------------------------------------------------------------
# time advance
# ---------------------------------------------------------------------------

def _time_candidates(s: SimState, const: EngineConst):
    """Non-transition next-event candidates: (arrivals, finishes, policy).

    Policy candidates: the idle-timeout expiries (``sleep_enabled``), the RL
    decision tick ``t + rl_interval`` (``rl_enabled``; ``INF_TIME`` when
    unset, which stays within int32) and the forecast review tick ``t +
    horizon`` (``forecast_enabled``; a zero horizon gives ``t``, which the
    callers' strictly-future clamp drops, so it adds no batch). They may be
    <= t; callers clamp them strictly-future."""
    t = s.t
    waiting_future = (s.job_status == WAITING) & (s.job_subtime > t)
    arr = torch.where(waiting_future, s.job_subtime, INF).amin()
    running = s.job_status == RUNNING
    fin = torch.where(running & (s.job_finish > t), s.job_finish, INF).amin()
    policy_cands = []
    if const.policy.sleep_enabled:
        idle_unres = (s.node_job < 0) & (s.node_state == IDLE)
        expiry = s.node_idle_since + const.timeout
        policy_cands.append(
            torch.where(idle_unres & (expiry > t), expiry, INF).amin()
        )
    if const.policy.rl_enabled:
        policy_cands.append(t + const.rl_interval)
    if const.policy.forecast_enabled:
        policy_cands.append(t + const.forecast_horizon)
    return arr, fin, policy_cands


def _next_transition(s: SimState) -> torch.Tensor:
    trans = (s.node_state == SWITCHING_ON) | (s.node_state == SWITCHING_OFF)
    return torch.where(trans & (s.node_until > s.t), s.node_until, INF).amin()


def _earliest(s: SimState, arr, fin, tr, policy_cands) -> torch.Tensor:
    nt = torch.minimum(torch.minimum(arr, fin), tr)
    for c in policy_cands:
        nt = torch.minimum(nt, torch.where(c > s.t, c, INF))
    return nt


def next_time(
    s: SimState,
    const: EngineConst,
    cfg: EngineConfig,
    tr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Earliest strictly-future event time (INF when none): arrivals,
    finishes, transition completions and the policy candidates."""
    if tr is None:
        tr = _next_transition(s)
    arr, fin, policy_cands = _time_candidates(s, const)
    return _earliest(s, arr, fin, tr, policy_cands)


def horizon(
    s: SimState, const: EngineConst, cfg: EngineConfig, fused: Optional[bool] = None
) -> Tuple[torch.Tensor, Optional["EventAux"]]:
    """The next event time and what the accrual reuses: the fused event
    pass (:func:`event_horizon`) under ``fused`` (default
    ``cfg.fused_events``), else the legacy loop's :func:`next_time` and no
    byproducts, so :func:`accrue_energy` gathers the draw itself and no
    event kernel runs (the reference's ``run_sim`` and env step branch so)."""
    if cfg.fused_events if fused is None else fused:
        return event_horizon(s, const, cfg)
    return next_time(s, const, cfg), None


def _node_power_draw(s: SimState, const: EngineConst) -> torch.Tensor:
    """f32[N] instantaneous per-node draw; under rule 9 an ACTIVE node draws
    its group's current-mode watts."""
    node_power = const.power.gather(1, s.node_state.long()[:, None])[:, 0]
    if const.policy.dvfs_enabled:
        gid = const.group_id.long()
        mode_w = const.dvfs_watts[gid, s.dvfs_mode.long()[gid]]
        node_power = torch.where(s.node_state == ACTIVE, mode_w, node_power)
    return node_power


class EventAux(NamedTuple):
    """Byproducts of the fused event pass, consumed by :func:`accrue_energy`
    and the quiet-batch dispatch. Exactly one of ``node_power`` (per-node
    route) and ``draw`` (kernel or grouped route, per-state watts) is set;
    ``occ`` accompanies ``draw`` on the grouped path only."""

    node_power: Optional[torch.Tensor]  # f32[N] per-node draw
    draw: Optional[torch.Tensor]  # f32[G, 5] per-state draw
    occ: Optional[torch.Tensor]  # i32[G, 5] occupancy (grouped path only)
    quiet: torch.Tensor  # bool: next batch is transitions/expiries only


def _fused_kernel_on(cfg: EngineConfig, device: torch.device) -> bool:
    """Resolve ``cfg.fused_kernel`` (None = auto: the kernel on CUDA)."""
    if cfg.fused_kernel is not None:
        return bool(cfg.fused_kernel)
    return device.type == "cuda"


def _quiet_enabled(const: EngineConst, cfg: EngineConfig) -> bool:
    """Quiet-event batching applies when the rules a quiet batch skips are
    statically absent: rules 8-10 and a controller may change state on any
    batch (pending commands, the DVFS ladder, the forecast update), so they
    turn it off."""
    pp = const.policy
    return (
        cfg.fused_events
        and getattr(cfg.policy, "controller", None) is None
        and not pp.rl_enabled
        and not pp.dvfs_enabled
        and not pp.forecast_enabled
    )


def _quiet_batch(s: SimState, const: EngineConst, cfg: EngineConfig) -> SimState:
    """Stripped batch for quiet events: transition completions and
    idle-timeout expiries only — bit-exact with :func:`process_batch` on
    the batches :func:`event_horizon` classifies quiet (the reference's
    argument: an empty queue makes rule 6 select every candidate and rule 7
    a no-op)."""
    s = _complete_transitions(s, const)
    if const.policy.sleep_enabled:
        cand = (
            (s.node_job < 0)
            & (s.node_state == IDLE)
            & (s.t - s.node_idle_since >= const.timeout)
        )
        s = s._replace(
            node_state=torch.where(cand, SWITCHING_OFF, s.node_state),
            node_until=torch.where(cand, s.t + const.t_off, s.node_until),
            n_switch_off=s.n_switch_off + cand.sum(dtype=I32),
        )
    return s._replace(n_batches=s.n_batches + 1)


def event_horizon(
    s: SimState, const: EngineConst, cfg: EngineConfig
) -> Tuple[torch.Tensor, EventAux]:
    """The fused event pass: one read of the node arrays yields the
    next-event time AND the power draw for the coming accrual interval, plus
    the quiet-batch classification.

    On the grouped path the node arrays reduce to the [G, 5] occupancy
    histogram and the next-transition min through ``event_fuse_occ`` (the
    CUDA kernel on a CUDA device; see the module docstring for
    ``fused_kernel``) or the plain :func:`_occupancy`; the counts are exact
    either way, and the draw is their contraction with the group power
    table, the ACTIVE column at the DVFS mode watts under rule 9. On the
    dense path of a single-group platform with DVFS off the histogram and
    the min go through ``event_fuse_ledger``, fed ``const.power[0]`` — the
    per-state table of the one group; under DVFS the ACTIVE watts follow the
    mode table, which the kernel does not see, so the per-node route runs
    instead (the reference's gate). The i32 min is exact either way; the
    ledger kernel's per-state sums differ from the per-node route only in
    reduction order, so the schedule is bit-exact and energy equal to
    rounding.
    """
    G = s.energy.shape[0]
    aux_occ = None
    if cfg.grouped_tables:
        if _fused_kernel_on(cfg, s.t.device):
            occ8, tr_v = event_fuse.event_fuse_occ(
                s.node_state[None], s.node_until[None], s.t.view(1),
                const.group_id, G,
            )
            # the f32 counts are exact integers
            aux_occ = occ8[0, :, :N_STATES].to(I32)
            tr = tr_v[0]
        else:
            aux_occ = _occupancy(s, const)
            tr = _next_transition(s)
        aux_power, aux_draw = None, _group_draw(s, aux_occ, const)
    elif (G == 1 and not const.policy.dvfs_enabled
          and _fused_kernel_on(cfg, s.t.device)):
        draw8, tr_v = event_fuse.event_fuse_ledger(
            s.node_state[None], s.node_until[None], s.t.view(1),
            const.power[0],
        )
        aux_power, aux_draw = None, draw8[:, :N_STATES]
        tr = tr_v[0]
    else:
        aux_power, aux_draw = _node_power_draw(s, const), None
        tr = _next_transition(s)
    arr, fin, policy_cands = _time_candidates(s, const)
    nt = _earliest(s, arr, fin, tr, policy_cands)
    if _quiet_enabled(const, cfg):
        busy = (
            ((s.job_status == WAITING) & (s.job_subtime <= s.t))
            | (s.job_status == ALLOCATED)
        ).any()
        quiet = (arr > nt) & (fin > nt) & ~busy
    else:
        quiet = torch.zeros((), dtype=torch.bool, device=nt.device)
    return nt, EventAux(
        node_power=aux_power, draw=aux_draw, occ=aux_occ, quiet=quiet
    )


def _ledger(s: SimState, const: EngineConst, node_power: torch.Tensor) -> torch.Tensor:
    """f32[G, 5] per-(group, state) draw: a one-hot sum over the nodes in a
    fixed order (deterministic on CUDA, unlike a float scatter-add)."""
    G = s.energy.shape[0]
    cell = const.group_id * N_STATES + s.node_state
    cells = torch.arange(G * N_STATES, dtype=I32, device=cell.device)
    onehot = cell[:, None] == cells[None, :]
    return torch.where(onehot, node_power[:, None], 0.0).sum(dim=0).view(
        G, N_STATES
    )


def accrue_energy(
    s: SimState,
    t_next: torch.Tensor,
    const: EngineConst,
    aux: Optional[EventAux] = None,
) -> SimState:
    """Accrue energy, the DVFS mode ledgers and the waiting integral over
    ``[s.t, t_next)``.

    On the grouped path the draw is the contraction of the occupancy
    histogram (from the event pass, or computed here by the legacy loop,
    which runs without one: the reference's ``_occupancy`` +
    ``_group_draw``) and the histogram is stored in ``SimState.occ``; on
    the dense path without ``aux`` the draw is gathered per node.

    Under rule 9 each group adds ``dt`` to ``mode_time[g, mode[g]]`` and its
    ACTIVE energy ``draw[g, ACTIVE] * dt`` to ``mode_energy[g, mode[g]]``, on
    every route. On the per-node route the reference scatter-adds each
    ACTIVE node's ``watts * dt``; here the group's fixed-order ledger sum is
    used instead, since every node of a group shares its mode: the same
    quantity to rounding, and no float atomics (which would make a CUDA
    rerun order-dependent).
    """
    dt = torch.clamp(t_next - s.t, min=0).to(F32)
    occ = s.occ
    if aux is not None and aux.occ is not None:
        occ, draw = aux.occ, aux.draw
    elif const.tables is not None:
        occ = _occupancy(s, const)
        draw = _group_draw(s, occ, const)
    elif aux is not None and aux.draw is not None:
        draw = aux.draw  # ledger-kernel route (DVFS off): already [G=1, 5]
    else:
        node_power = (
            aux.node_power
            if aux is not None and aux.node_power is not None
            else _node_power_draw(s, const)
        )
        draw = _ledger(s, const, node_power)
    e, c = _kahan_add(s.energy, s.energy_c, draw * dt)
    mode_time, mode_energy = s.mode_time, s.mode_energy
    if const.policy.dvfs_enabled:
        modes = torch.arange(mode_time.shape[1], dtype=I32, device=dt.device)
        in_mode = s.dvfs_mode[:, None] == modes[None, :]  # one cell per group
        mode_time = mode_time + torch.where(in_mode, dt, 0.0)
        mode_energy = mode_energy + torch.where(
            in_mode, (draw[:, ACTIVE] * dt)[:, None], 0.0
        )
    n_waiting = (
        ((s.job_status == WAITING) & (s.job_subtime <= s.t))
        | (s.job_status == ALLOCATED)
    ).sum(dtype=F32)
    w, wc = _kahan_add(s.wait_integral, s.wait_c, n_waiting * dt)
    return s._replace(
        energy=e, energy_c=c, mode_time=mode_time, mode_energy=mode_energy,
        wait_integral=w, wait_c=wc, occ=occ,
    )


def all_done(s: SimState) -> torch.Tensor:
    return (s.job_status == DONE).all()


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def default_batch_cap(n_jobs: int) -> int:
    return 20 * n_jobs + 10_000


def trim_window(config: EngineConfig, n_jobs: int) -> EngineConfig:
    """Shrink the scheduler window to what the workload can fill (a window
    slot past ``n_jobs`` is always -1 padding; bit-exact by construction)."""
    W = max(1, min(config.window, n_jobs))
    if W == config.window:
        return config
    return dataclasses.replace(config, window=W)


def _loop(
    s: SimState,
    const: EngineConst,
    cfg: EngineConfig,
    cap: int,
    fused: bool,
    record=None,
) -> SimState:
    """The host loop of :func:`run_sim` and :func:`run_sim_gantt`: the
    first batch, then one host read per iteration and one batch, until
    every job is done, no event is left or ``cap`` batches ran.

    ``fused``: the next-event time and draw of each iteration come from
    :func:`event_horizon` and quiet batches run :func:`_quiet_batch`; else
    the legacy loop (:func:`horizon`). ``record(s, t_next)`` sees each
    batch's state before its accrual."""
    quiet_on = fused and _quiet_enabled(const, cfg)
    s = process_batch(s, const, cfg)
    nt, aux = horizon(s, const, cfg, fused)
    while True:
        nt_h, done, *quiet, n_batches = _read(
            nt, all_done(s), *((aux.quiet,) if quiet_on else ()), s.n_batches)
        if done or nt_h >= INF or n_batches >= cap:
            break
        if record is not None:
            record(s, nt)
        s = accrue_energy(s, nt, const, aux=aux)
        s = s._replace(t=nt)
        if quiet_on and quiet[0]:
            s = _quiet_batch(s, const, cfg)
        else:
            s = process_batch(s, const, cfg)
        nt, aux = horizon(s, const, cfg, fused)
    truncated = (not done) and nt_h < INF
    return s._replace(truncated=torch.full_like(s.truncated, truncated))


def run_sim(
    s: SimState,
    const: EngineConst,
    cfg: EngineConfig,
    max_batches: Optional[int] = None,
) -> SimState:
    """Run to completion on the device that holds ``s`` and ``const``.

    Each iteration runs ONE fused event pass (:func:`event_horizon`), whose
    next-event time and draw carry into the next iteration; quiet batches
    run the stripped :func:`_quiet_batch`. Under ``fused_events=False`` the
    legacy loop runs instead: :func:`next_time` and the accrual's own
    gather of the draw, every batch full, no event kernel (bit-exact with
    the fused loop, as in the reference). ``truncated`` is set on the
    returned state when the batch cap stopped the run with future events
    still pending. One host read per iteration decides the loop (module
    docstring).
    """
    check_supported(cfg)
    cap = max_batches or cfg.max_batches or default_batch_cap(
        int(s.job_status.shape[0])
    )
    return _loop(s, const, cfg, cap, cfg.fused_events)


def run_sim_gantt(
    s: SimState,
    const: EngineConst,
    cfg: EngineConfig,
    max_batches: int,
) -> Tuple[SimState, GanttLog]:
    """Like run_sim but records per-batch node-state snapshots for Gantt.

    The reference's loop shape: the legacy loop (``next_time`` then the
    accrual's own draw, no quiet batches) whatever ``fused_events`` says.
    ``max_batches`` also bounds the log; a cap-stopped run comes back with
    ``state.truncated`` set (the log is then a prefix).
    """
    check_supported(cfg)
    t0: List[torch.Tensor] = []
    t1: List[torch.Tensor] = []
    states: List[torch.Tensor] = []
    jobs: List[torch.Tensor] = []

    def record(s: SimState, nt: torch.Tensor) -> None:
        t0.append(s.t)
        t1.append(nt)
        states.append(s.node_state)
        jobs.append(torch.where(s.node_state == ACTIVE, s.node_job, -1))

    s = _loop(s, const, cfg, max_batches, False, record)
    N = s.node_state.shape[0]

    def stack(rows, shape):
        if rows:
            return torch.stack(rows)
        return torch.zeros(shape, dtype=I32, device=s.t.device)

    log = GanttLog(
        t0=stack(t0, (0,)), t1=stack(t1, (0,)),
        state=stack(states, (0, N)), job=stack(jobs, (0, N)), n=len(t0),
    )
    return s, log


def _warn_truncated(state: SimState, what: str) -> None:
    if bool(state.truncated):
        warnings.warn(
            f"{what} hit its batch cap before completing — the returned "
            "state/metrics describe a PARTIAL simulation (SimState.truncated"
            " / SimMetrics.truncated). Raise EngineConfig.max_batches (or "
            "pass max_batches) to run to completion.",
            RuntimeWarning,
            stacklevel=3,
        )


def simulate(
    platform: PlatformSpec,
    workload: Workload,
    config: EngineConfig,
    device: DeviceLike = None,
    job_capacity: Optional[int] = None,
) -> SimState:
    """Run ONE configuration to completion on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``; raises when CUDA is asked for and absent)."""
    dev = resolve_device(device)
    config = trim_window(config, len(workload))
    const = make_const(platform, config, device=dev)
    s = init_state(platform, workload, config, device=dev, job_capacity=job_capacity)
    cap = config.max_batches or default_batch_cap(len(workload))
    out = run_sim(s, const, config, max_batches=cap)
    _warn_truncated(out, f"simulate({config.label()!r})")
    return out


# the reference's engine also holds the batched sweep; here it lives in
# core/sweep.py, which imports this module, so its names load on first use
_SWEEP_NAMES = ("sweep", "sweep_async", "SimBatch", "PendingSweep", "cache_stats")


def __getattr__(name):
    if name not in _SWEEP_NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from repro_torch.core import sweep

    return getattr(sweep, name)
