"""Declarative power-policy layer and the PyTorch spelling of rules 6-7.

The declarative half — the :class:`PowerPolicy` stacks, :class:`PolicyParams`,
:func:`static_bool`, the ``from_label`` registry and the ``PSMVariant`` shim —
is a copy of the JAX reference's ``core/policy.py``: a label names a point on
the policy axis, and both engines read the same flags.

The rule half is the PyTorch counterpart of the reference's rule functions:
rule 6 (idle-timeout switch-off, with the IPM demand cap), rule 7 (IPM
proactive wake), rule 8 (RL power commands, global or per group), rule 9
(DVFS: the queue-pressure ladder or agent mode commands, and the
remaining-work rescale) and rule 10 (the EWMA arrival forecast: proactive
wake and the DVFS pre-ramp), the ``"pack"`` node-order key and the
node-speed helpers used at job start. The engine only runs a single
configuration, so flags are always concrete Python bools
(``PolicyParams.static()``) and every gate is a Python branch; a rule that
is off is never called.

The batched sweep (``core/sweep.py``) and the batched RL env carry the
flags as ``[E]`` bool tensors (:meth:`PolicyParams.traced`,
:func:`stack_params`) and run rules 6-10 over ``[E, N]`` and ``[E, J]``
state through the ``*_rows`` functions below: each flag reaches them as a
*row gate*, ``True`` (every row), ``False`` (no row) or an ``[E]`` bool
tensor, and a row whose gate is off selects no node, so its fields and
counters stay bit for bit as they were (the reference's §Traced policy
axis); each row whose gate is on equals the single-state function on that
row bit for bit (per-row selections are stable row sorts).

The f32 expressions that the engines and the oracle hold bit for bit (the
EWMA update, the observed gap, the pressure floor and the DVFS rescale) are
spelled as separate PyTorch ops in the reference's order, each rounding
once: no ``lerp``, ``addcmul`` or other fused form. No rule reads a device
value into Python.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import (
    IDLE,
    INF_TIME,
    RUNNING,
    SLEEP,
    SWITCHING_OFF,
    SWITCHING_ON,
    WAITING,
    BasePolicy,
    PSMVariant,
    did_you_mean,
)

I32 = torch.int32
F32 = torch.float32
INF = int(INF_TIME)


class PolicyParams(NamedTuple):
    """The policy axis: per-scenario behaviour flags (all bool).

    The single run carries these as concrete Python bools (:meth:`static`);
    the batched sweep as ``[E]`` bool tensors, one element a scenario
    (:func:`stack_params`).
    """

    backfill: Any  # EASY backfilling; False = FCFS stop-at-head (rule 4)
    eager_ready: Any  # scheduling ignores power states (ready-time table)
    sleep_enabled: Any  # rule 6 active (idle-timeout switch-off)
    ipm_enabled: Any  # rule 6 demand cap + rule 7 proactive wake
    rl_enabled: Any  # rule 8 active (agent power commands)
    rl_grouped: Any  # rule 8 selects per node group
    dvfs_enabled: Any  # rule 9 active (runtime per-group DVFS switching)
    dvfs_rl: Any  # rule 9 modes from agent commands (else pressure ladder)
    forecast_enabled: Any  # rule 10 active (EWMA forecast, proactive wake)
    forecast_dvfs: Any  # rule 10 also pre-ramps DVFS modes (needs rule 9)

    def static(self) -> "PolicyParams":
        """The concrete Python-bool spelling (single-config specialization)."""
        return PolicyParams(*[bool(v) for v in self])

    def traced(self, device) -> "PolicyParams":
        """The tensor spelling: a 0-d bool tensor a flag on ``device`` (the
        reference's ``traced()``; :func:`stack_params` stacks rows of it)."""
        return PolicyParams(
            *[torch.tensor(bool(v), device=device) for v in self]
        )


def stack_params(rows, device) -> PolicyParams:
    """K scenario rows of flags (each a :class:`PolicyParams` of bools or
    0-d tensors) as one :class:`PolicyParams` of ``[K]`` bool tensors on
    ``device``: the scenario axis of a sweep."""
    return PolicyParams(*[
        torch.tensor([bool(r[i]) for r in rows], dtype=torch.bool, device=device)
        for i in range(len(PolicyParams._fields))
    ])


def static_bool(flag) -> Optional[bool]:
    """Python bool when ``flag`` is concrete, None otherwise (the reference's
    flag accessor; the PyTorch engine only ever sees concrete flags)."""
    if isinstance(flag, (bool, np.bool_)):
        return bool(flag)
    return None


# ---------------------------------------------------------------------------
# rules 6-7 (SEMANTICS.md), on tensors
# ---------------------------------------------------------------------------

def queued_demand(s) -> torch.Tensor:
    """i32 total nodes asked by arrived WAITING jobs."""
    waiting = (s.job_status == WAITING) & (s.job_subtime <= s.t)
    return torch.where(waiting, s.job_res, 0).sum(dtype=I32)


def _available(s) -> torch.Tensor:
    """i32 unreserved IDLE or SWITCHING_ON nodes (capacity for the queue)."""
    return (
        (s.node_job < 0)
        & ((s.node_state == IDLE) | (s.node_state == SWITCHING_ON))
    ).sum(dtype=I32)


def timeout_switch_off(s, const, ipm_cap: bool):
    """Rule 6: switch off expired idle nodes, longest-idle first (ties by id).

    ``ipm_cap`` (PSAS+IPM) caps the count so available capacity never drops
    below queued demand. Without the cap every candidate is selected, so the
    k-longest-idle sort is skipped (the same pruning as the reference).
    """
    cand = (
        (s.node_job < 0)
        & (s.node_state == IDLE)
        & (s.t - s.node_idle_since >= const.timeout)
    )
    if not ipm_cap:
        sel = cand
    else:
        n_cand = cand.sum(dtype=I32)
        allowed = torch.clamp(_available(s) - queued_demand(s), min=0)
        k = torch.minimum(n_cand, allowed)
        key = torch.where(cand, s.node_idle_since, INF)  # longest idle first
        order = torch.argsort(key, stable=True)
        n = key.shape[0]
        sel_sorted = torch.arange(n, device=key.device, dtype=I32) < k
        sel = torch.empty_like(cand)
        sel[order] = sel_sorted
        sel = sel & cand
    return s._replace(
        node_state=torch.where(sel, SWITCHING_OFF, s.node_state),
        node_until=torch.where(sel, s.t + const.t_off, s.node_until),
        n_switch_off=s.n_switch_off + sel.sum(dtype=I32),
    )


def ipm_wake(s, const):
    """Rule 7: wake sleeping nodes (lowest id first) to cover queued demand."""
    deficit = queued_demand(s) - _available(s)
    cand = (s.node_job < 0) & (s.node_state == SLEEP)
    sel = cand & (torch.cumsum(cand, 0, dtype=I32) <= deficit)
    return s._replace(
        node_state=torch.where(sel, SWITCHING_ON, s.node_state),
        node_until=torch.where(sel, s.t + const.t_on, s.node_until),
        n_switch_on=s.n_switch_on + sel.sum(dtype=I32),
    )


# ---------------------------------------------------------------------------
# rules 6-7 over a scenario axis: [E, N] and [E, J] state, [E] row gates
# (rules 8-10 over rows follow rules 8, 9 and 10 below)
# ---------------------------------------------------------------------------

def queued_demand_rows(s) -> torch.Tensor:
    """i32[E]: :func:`queued_demand` of each row."""
    waiting = (s.job_status == WAITING) & (s.job_subtime <= s.t[:, None])
    return torch.where(waiting, s.job_res, 0).sum(dim=-1, dtype=I32)


def available_rows(s) -> torch.Tensor:
    """i32[E]: :func:`_available` of each row."""
    return (
        (s.node_job < 0)
        & ((s.node_state == IDLE) | (s.node_state == SWITCHING_ON))
    ).sum(dim=-1, dtype=I32)


def _gated(sel, gate):
    """``sel`` [E, N] with the rows whose gate is off cleared."""
    return sel if gate is True else sel & gate[:, None]


def timeout_switch_off_rows(s, const, enabled, ipm_cap):
    """Rule 6 on each row whose ``enabled`` gate is on; rows whose
    ``ipm_cap`` gate is on are capped as in :func:`timeout_switch_off`
    (``enabled`` is not ``False``: the caller skips a rule no row runs).
    ``const`` holds ``[E, ...]`` tables."""
    t = s.t[:, None]
    cand = _gated(
        (s.node_job < 0)
        & (s.node_state == IDLE)
        & (t - s.node_idle_since >= const.timeout[:, None]),
        enabled,
    )
    sel = cand
    if ipm_cap is not False:
        allowed = torch.clamp(available_rows(s) - queued_demand_rows(s), min=0)
        capped = _select_longest_idle(cand, s.node_idle_since, allowed)
        sel = capped if ipm_cap is True else torch.where(
            ipm_cap[:, None], capped, cand
        )
    return s._replace(
        node_state=torch.where(sel, SWITCHING_OFF, s.node_state),
        node_until=torch.where(sel, t + const.t_off, s.node_until),
        n_switch_off=s.n_switch_off + sel.sum(dim=-1, dtype=I32),
    )


def ipm_wake_rows(s, const, enabled):
    """Rule 7 on each row whose ``enabled`` gate is on (not ``False``)."""
    deficit = queued_demand_rows(s) - available_rows(s)
    cand = (s.node_job < 0) & (s.node_state == SLEEP)
    sel = _gated(
        cand & (torch.cumsum(cand, dim=-1, dtype=I32) <= deficit[:, None]),
        enabled,
    )
    return s._replace(
        node_state=torch.where(sel, SWITCHING_ON, s.node_state),
        node_until=torch.where(sel, s.t[:, None] + const.t_on, s.node_until),
        n_switch_on=s.n_switch_on + sel.sum(dim=-1, dtype=I32),
    )


def pack_key(s, const) -> torch.Tensor:
    """f32[N] queue-aware allocation key for ``node_order="pack"``.

    Groups with the FEWEST idle unreserved nodes come first, so jobs pack
    into nearly-full groups and lightly used groups drain to empty (and can
    sleep whole under rule 6). Idle unreserved nodes sort before every other
    eligible node (the others carry an ``N + 1`` band offset), so packing
    never wakes a sleeper while idle capacity remains. Computed once per
    scheduler pass and frozen across its attempts. The per-group counts are
    summed in int32 (exact in any order, so the CUDA ``index_add_``'s atomics
    are deterministic) and the key is exact in f32: integer counts plus one
    band, at most 2N + 1 < 2**24.
    """
    G = s.energy.shape[0]
    N = s.node_state.shape[0]
    gid = const.group_id.long()
    idle_unres = (s.node_job < 0) & (s.node_state == IDLE)
    counts = torch.zeros(G, dtype=I32, device=gid.device).index_add_(
        0, gid, idle_unres.to(I32)
    )
    band = torch.where(idle_unres, 0.0, float(N + 1))
    return counts[gid].to(torch.float32) + band


def pack_key_rows(s, const) -> torch.Tensor:
    """f32[E, N]: :func:`pack_key` of each row, by the row's own group ids
    (``const.group_id`` ``[E, N]``, a stride-0 view when the rows share a
    platform). The counts are an int32 scatter-add along the node axis,
    exact in any order, so each row equals :func:`pack_key` of that row bit
    for bit."""
    E, G = s.energy.shape[:2]
    N = s.node_state.shape[1]
    gid = const.group_id.long()
    idle_unres = (s.node_job < 0) & (s.node_state == IDLE)
    counts = torch.zeros((E, G), dtype=I32, device=gid.device).scatter_add_(
        1, gid, idle_unres.to(I32)
    )
    band = torch.where(idle_unres, 0.0, float(N + 1))
    return counts.gather(1, gid).to(torch.float32) + band


def _select_longest_idle(cand, idle_since, k):
    """Boolean mask of the ``k`` longest-idle candidates (ties by node id).

    ``cand`` is ``[N]`` with a 0-d ``k``, or ``[G, N]`` with ``k`` of
    ``[G]``: one stable sort per row along the last dim, where the reference
    vmaps the 1-D selection over the groups. ``k`` stays a tensor."""
    key = torch.where(cand, idle_since, INF)
    order = torch.argsort(key, dim=-1, stable=True)
    k = torch.minimum(cand.sum(dim=-1, dtype=I32), k)
    n = key.shape[-1]
    sel_sorted = torch.arange(n, dtype=I32, device=key.device) < k[..., None]
    return torch.zeros_like(cand).scatter(-1, order, sel_sorted) & cand


def apply_rl_commands(s, const, grouped: bool):
    """Rule 8: apply the pending RL power commands, then clear them.

    ``rl_on_cmd``/``rl_off_cmd`` are ``i32[G]`` per-group command vectors.
    Global mode (``grouped=False``): the counts are the vector sums, and
    selection is cluster-wide (wake the lowest-id sleeping nodes, sleep the
    longest-idle unreserved idle ones). Grouped mode: group g wakes up to
    ``on[g]`` of its own sleeping nodes (lowest id first) and sleeps up to
    ``off[g]`` of its own unreserved idle nodes (longest idle first)."""
    cand_on = (s.node_job < 0) & (s.node_state == SLEEP)
    cand_off = (s.node_job < 0) & (s.node_state == IDLE)
    G = s.rl_on_cmd.shape[0]
    if grouped:
        groups = torch.arange(G, dtype=I32, device=cand_on.device)
        same = const.group_id[None, :] == groups[:, None]  # [G, N]
        ranks_on = torch.cumsum(cand_on[None, :] & same, dim=1, dtype=I32)
        sel_on = cand_on & (same & (ranks_on <= s.rl_on_cmd[:, None])).any(0)
        sel_off = _select_longest_idle(
            cand_off[None, :] & same, s.node_idle_since, s.rl_off_cmd
        ).any(0)
    else:
        sel_on = cand_on & (
            torch.cumsum(cand_on, 0, dtype=I32) <= s.rl_on_cmd.sum(dtype=I32)
        )
        sel_off = _select_longest_idle(
            cand_off, s.node_idle_since, s.rl_off_cmd.sum(dtype=I32)
        )
    state = torch.where(sel_on, SWITCHING_ON, s.node_state)
    state = torch.where(sel_off, SWITCHING_OFF, state)
    until = torch.where(sel_on, s.t + const.t_on, s.node_until)
    until = torch.where(sel_off, s.t + const.t_off, until)
    return s._replace(
        node_state=state,
        node_until=until,
        rl_on_cmd=torch.zeros_like(s.rl_on_cmd),
        rl_off_cmd=torch.zeros_like(s.rl_off_cmd),
        n_switch_on=s.n_switch_on + sel_on.sum(dtype=I32),
        n_switch_off=s.n_switch_off + sel_off.sum(dtype=I32),
    )


def apply_rl_commands_rows(s, const, grouped, enabled):
    """Rule 8 on each row whose ``enabled`` gate is on (not ``False``), over
    ``[E, N]`` state and ``[E, G]`` command vectors. ``grouped`` is a row
    gate too: its rows select per group, the others cluster-wide, each row
    exactly as :func:`apply_rl_commands` selects for one state (the per-group
    sorts run over ``[E, G, N]``). A row whose gate is off keeps its nodes,
    counters and commands."""
    cand_on = (s.node_job < 0) & (s.node_state == SLEEP)
    cand_off = (s.node_job < 0) & (s.node_state == IDLE)
    G = s.rl_on_cmd.shape[-1]
    if grouped is not False:
        groups = torch.arange(G, dtype=I32, device=cand_on.device)
        same = const.group_id[:, None, :] == groups[:, None]  # [E, G, N]
        ranks_on = torch.cumsum(cand_on[:, None, :] & same, dim=-1, dtype=I32)
        on_g = cand_on & (same & (ranks_on <= s.rl_on_cmd[..., None])).any(1)
        off_g = _select_longest_idle(
            cand_off[:, None, :] & same, s.node_idle_since[:, None, :],
            s.rl_off_cmd,
        ).any(1)
    if grouped is not True:
        on_all = cand_on & (
            torch.cumsum(cand_on, dim=-1, dtype=I32)
            <= s.rl_on_cmd.sum(dim=-1, dtype=I32)[:, None]
        )
        off_all = _select_longest_idle(
            cand_off, s.node_idle_since, s.rl_off_cmd.sum(dim=-1, dtype=I32)
        )
    if grouped is True:
        sel_on, sel_off = on_g, off_g
    elif grouped is False:
        sel_on, sel_off = on_all, off_all
    else:
        sel_on = torch.where(grouped[:, None], on_g, on_all)
        sel_off = torch.where(grouped[:, None], off_g, off_all)
    sel_on, sel_off = _gated(sel_on, enabled), _gated(sel_off, enabled)
    t = s.t[:, None]
    state = torch.where(sel_on, SWITCHING_ON, s.node_state)
    state = torch.where(sel_off, SWITCHING_OFF, state)
    until = torch.where(sel_on, t + const.t_on, s.node_until)
    until = torch.where(sel_off, t + const.t_off, until)

    def cleared(cmd):
        if enabled is True:
            return torch.zeros_like(cmd)
        return torch.where(enabled[:, None], 0, cmd)

    return s._replace(
        node_state=state,
        node_until=until,
        rl_on_cmd=cleared(s.rl_on_cmd),
        rl_off_cmd=cleared(s.rl_off_cmd),
        n_switch_on=s.n_switch_on + sel_on.sum(dim=-1, dtype=I32),
        n_switch_off=s.n_switch_off + sel_off.sum(dim=-1, dtype=I32),
    )


def effective_node_speed_rows(const, mode, enabled) -> torch.Tensor:
    """f32[E, N]: :func:`effective_node_speed` of each row, the mode table's
    speed on the rows whose ``enabled`` gate is on and the base speed on the
    others (``const`` holds ``[E, ...]`` tables, ``mode`` is ``[E, G]``)."""
    if enabled is False:
        return const.speed
    E = mode.shape[0]
    M = const.dvfs_speed.shape[-1]
    gid = const.group_id.long()
    node_mode = mode.long().gather(1, gid)
    table = const.dvfs_speed.reshape(E, -1).gather(1, gid * M + node_mode)
    if enabled is True:
        return table
    return torch.where(enabled[:, None], table, const.speed)


def alloc_min_speed_rows(node_job, node_speed, n_jobs: int) -> torch.Tensor:
    """f32[E, J]: :func:`alloc_min_speed` of each row (a scatter-min, exact
    in any order)."""
    cj = torch.clamp(node_job, min=0).long()
    src = torch.where(node_job >= 0, node_speed, float("inf"))
    out = torch.full(
        (node_job.shape[0], n_jobs), float("inf"), dtype=torch.float32,
        device=node_job.device,
    )
    return out.scatter_reduce(1, cj, src, reduce="amin", include_self=True)


def apply_dvfs_modes_rows(s, const, target, enabled, terminate_overrun=False):
    """:func:`apply_dvfs_modes` of each row: ``target`` is ``[E, G]`` and
    ``enabled`` a row gate (not ``False``); a row whose gate is off keeps
    its modes and jobs. The contract expressions are the single state's, op
    for op."""
    mode = target if enabled is True else torch.where(
        enabled[:, None], target, s.dvfs_mode
    )
    eff = effective_node_speed_rows(const, mode, True)
    J = s.job_status.shape[-1]
    alloc_min = alloc_min_speed_rows(s.node_job, eff, J)
    running = (s.job_status == RUNNING) & ~s.job_terminated
    speed_min = torch.where(running, alloc_min, s.job_speed)
    live = _gated(running, enabled)
    changed = live & (speed_min != s.job_speed)
    t = s.t[:, None]
    rem = torch.clamp(s.job_finish - t, min=1).to(F32)
    work = rem * s.job_speed  # f32 remaining work (contract expression)
    new_rem = torch.clamp(torch.ceil(work / speed_min).to(I32), min=1)
    new_finish = t + new_rem
    terminated = s.job_terminated
    if terminate_overrun:
        cap = s.job_start + s.job_reqtime
        capped = changed & (new_finish > cap)
        new_finish = torch.minimum(new_finish, cap)
        terminated = terminated | capped
    finish = torch.where(changed, new_finish, s.job_finish)
    return s._replace(
        dvfs_mode=mode,
        job_speed=torch.where(live, speed_min, s.job_speed),
        job_finish=finish,
        job_eff=torch.where(changed, finish - s.job_start, s.job_eff),
        job_terminated=terminated,
    )


def apply_dvfs_rows(s, const, enabled, rl, terminate_overrun=False):
    """Rule 9 on each row whose ``enabled`` gate is on (not ``False``): the
    queue-pressure ladder, or on the rows of the ``rl`` gate the pending mode
    commands, then :func:`apply_dvfs_modes_rows`; each row as
    :func:`apply_dvfs` runs for one state."""
    N = s.node_state.shape[-1]
    n_modes = const.dvfs_n_modes  # [E, G]
    if rl is not True:
        ladder = torch.minimum(
            n_modes - 1, (queued_demand_rows(s)[:, None] * n_modes) // N
        )
    if rl is not False:
        clipped = torch.minimum(torch.clamp(s.rl_mode_cmd, min=0), n_modes - 1)
        commanded = torch.where(s.rl_mode_cmd >= 0, clipped, s.dvfs_mode)
    if rl is True:
        target = commanded
    elif rl is False:
        target = ladder
    else:
        target = torch.where(rl[:, None], commanded, ladder)
    s = apply_dvfs_modes_rows(s, const, target.to(I32), enabled, terminate_overrun)
    cmd = s.rl_mode_cmd
    return s._replace(
        rl_mode_cmd=torch.full_like(cmd, -1) if enabled is True
        else torch.where(enabled[:, None], -1, cmd)
    )


def effective_node_speed(const, mode, enabled: bool) -> torch.Tensor:
    """f32[N] node speed under the DVFS mode vector ``mode`` (i32[G]): each
    node's group's speed in the group's mode when ``enabled``, the base
    ``const.speed`` otherwise. Shared by job start (rule 5) and the rescale
    (rule 9)."""
    if not enabled:
        return const.speed
    gid = const.group_id.long()
    return const.dvfs_speed[gid, mode.long()[gid]]


def alloc_min_speed(node_job, node_speed, n_jobs: int) -> torch.Tensor:
    """f32[J] min node speed over each job's allocated nodes (inf when the
    job holds none) — the cross-engine realized-runtime contract's scatter.
    A scatter-min is exact in any order, so it is deterministic on CUDA."""
    cj = torch.clamp(node_job, min=0).long()
    src = torch.where(node_job >= 0, node_speed, float("inf"))
    out = torch.full(
        (n_jobs,), float("inf"), dtype=torch.float32, device=node_job.device
    )
    return out.scatter_reduce(0, cj, src, reduce="amin", include_self=True)


def apply_dvfs_modes(s, const, target, enabled=True, terminate_overrun=False):
    """Install the DVFS mode vector ``target`` (i32[G]) where ``enabled``
    and rescale the remaining work — the shared tail of rules 9 and 10.

    ``enabled`` is True or a bool device scalar (rule 10's pre-ramp fires
    only under a positive forecast). Every RUNNING, non-terminated job whose
    allocation's effective speed changed gets its remaining wall time
    rescaled by the f32 contract expression
    ``max(ceil((f32(finish - t) * old_speed) / new_speed), 1)``; under
    ``terminate_overrun`` the new finish is capped at ``start + reqtime``
    and the job is marked terminated when the cap bites. The speeds are the
    mode table's whether or not ``enabled`` holds: with it off every output
    keeps its old value, so the table only feeds discarded lanes."""
    gate = enabled is True
    mode = target if gate else torch.where(enabled, target, s.dvfs_mode)
    eff = effective_node_speed(const, mode, True)
    J = s.job_status.shape[0]
    alloc_min = alloc_min_speed(s.node_job, eff, J)
    running = (s.job_status == RUNNING) & ~s.job_terminated
    speed_min = torch.where(running, alloc_min, s.job_speed)
    live = running if gate else running & enabled
    changed = live & (speed_min != s.job_speed)
    rem = torch.clamp(s.job_finish - s.t, min=1).to(F32)
    work = rem * s.job_speed  # f32 remaining work (contract expression)
    new_rem = torch.clamp(torch.ceil(work / speed_min).to(I32), min=1)
    new_finish = s.t + new_rem
    terminated = s.job_terminated
    if terminate_overrun:
        cap = s.job_start + s.job_reqtime
        capped = changed & (new_finish > cap)
        new_finish = torch.minimum(new_finish, cap)
        terminated = terminated | capped
    finish = torch.where(changed, new_finish, s.job_finish)
    return s._replace(
        dvfs_mode=mode,
        job_speed=torch.where(live, speed_min, s.job_speed),
        job_finish=finish,
        job_eff=torch.where(changed, finish - s.job_start, s.job_eff),
        job_terminated=terminated,
    )


def apply_dvfs(s, const, terminate_overrun: bool = False, rl: bool = False):
    """Rule 9: per-group DVFS mode selection, then the install and rescale
    of :func:`apply_dvfs_modes`.

    ``rl=False``: the queue-pressure ladder, group g's mode
    ``min(n_modes[g] - 1, demand * n_modes[g] // N)``. ``rl=True``: the
    pending ``rl_mode_cmd`` (-1 = no change), clamped per group. The
    command vector is cleared either way."""
    N = s.node_state.shape[0]
    n_modes = const.dvfs_n_modes
    if rl:
        clipped = torch.minimum(
            torch.clamp(s.rl_mode_cmd, min=0), n_modes - 1
        )
        target = torch.where(s.rl_mode_cmd >= 0, clipped, s.dvfs_mode)
    else:
        target = torch.minimum(n_modes - 1, (queued_demand(s) * n_modes) // N)
    s = apply_dvfs_modes(s, const, target.to(I32), True, terminate_overrun)
    return s._replace(rl_mode_cmd=torch.full_like(s.rl_mode_cmd, -1))


def forecast_pressure(s, const) -> torch.Tensor:
    """i32 predicted extra node demand over the forecast horizon (rule 10):
    ``floor((horizon / max(gap, 1)) * res)``, clipped to ``[0, N]`` in f32
    before the i32 cast, so an extreme horizon/gap ratio saturates at N. A
    zero horizon, or a predictor that never saw an arrival, predicts 0."""
    gap = torch.clamp(s.fc_gap, min=1.0)
    horizon = const.forecast_horizon.to(F32)
    pressure = (horizon / gap) * s.fc_res
    N = s.node_state.shape[-1]
    return torch.clamp(torch.floor(pressure), 0.0, float(N)).to(I32)


def apply_forecast(s, const, terminate_overrun: bool = False,
                   dvfs_ramp: bool = False):
    """Rule 10: EWMA arrival-pressure forecast — predictor update, proactive
    wake and, with ``dvfs_ramp`` (rule 9 composed), the DVFS pre-ramp.

    Arrivals with ``fc_prev_t < subtime <= t`` are this batch's burst; its
    observed gap ``f32(t - fc_last_arr) / f32(n_new)`` and mean ask feed the
    strict-form EWMAs ``a*obs + (1-a)*ewma``. A positive predicted pressure
    widens rule 7's deficit: sleeping nodes are woken (lowest id first) until
    the unreserved IDLE/SWITCHING_ON capacity covers ``demand + f_extra``.
    The pre-ramp raises each group toward the forecast-adjusted ladder, never
    below rule 9's mode, through :func:`apply_dvfs_modes`."""
    newly = s.job_exists & (s.job_subtime <= s.t) & (s.job_subtime > s.fc_prev_t)
    n_new = newly.sum(dtype=I32)
    denom = torch.clamp(n_new, min=1).to(F32)
    gap_obs = (s.t - s.fc_last_arr).to(F32) / denom
    res_obs = torch.where(newly, s.job_res, 0).sum(dtype=I32).to(F32) / denom
    a = const.forecast_alpha
    keep = 1.0 - a
    upd = n_new > 0
    s = s._replace(
        fc_gap=torch.where(upd, a * gap_obs + keep * s.fc_gap, s.fc_gap),
        fc_res=torch.where(upd, a * res_obs + keep * s.fc_res, s.fc_res),
        fc_last_arr=torch.where(upd, s.t, s.fc_last_arr),
        fc_prev_t=s.t,
    )

    f_extra = forecast_pressure(s, const)
    deficit = queued_demand(s) + f_extra - _available(s)
    cand = (s.node_job < 0) & (s.node_state == SLEEP)
    sel = cand & (torch.cumsum(cand, 0, dtype=I32) <= deficit) & (f_extra > 0)
    s = s._replace(
        node_state=torch.where(sel, SWITCHING_ON, s.node_state),
        node_until=torch.where(sel, s.t + const.t_on, s.node_until),
        n_switch_on=s.n_switch_on + sel.sum(dtype=I32),
    )
    if not dvfs_ramp:
        return s
    N = s.node_state.shape[0]
    n_modes = const.dvfs_n_modes
    fc_mode = torch.minimum(
        n_modes - 1, ((queued_demand(s) + f_extra) * n_modes) // N
    )
    target = torch.maximum(s.dvfs_mode, fc_mode.to(I32))
    return apply_dvfs_modes(s, const, target, f_extra > 0, terminate_overrun)


def apply_forecast_rows(s, const, enabled, dvfs_ramp, terminate_overrun=False):
    """Rule 10 on each row whose ``enabled`` gate is on (not ``False``), over
    ``[E, N]`` and ``[E, J]`` state: each row's EWMA predictor, its own
    ``[E]`` horizon and review tick, the proactive wake and, on the rows of
    the ``dvfs_ramp`` gate, the DVFS pre-ramp through
    :func:`apply_dvfs_modes_rows`; each row as :func:`apply_forecast` runs
    for one state, op for op. A row whose gate is off keeps its predictor,
    nodes, counters and modes."""
    t = s.t
    newly = (s.job_exists & (s.job_subtime <= t[:, None])
             & (s.job_subtime > s.fc_prev_t[:, None]))
    n_new = newly.sum(dim=-1, dtype=I32)
    denom = torch.clamp(n_new, min=1).to(F32)
    gap_obs = (t - s.fc_last_arr).to(F32) / denom
    res_obs = torch.where(newly, s.job_res, 0).sum(dim=-1, dtype=I32).to(F32) / denom
    a = const.forecast_alpha
    keep = 1.0 - a
    upd = n_new > 0
    if enabled is not True:
        upd = upd & enabled
    s = s._replace(
        fc_gap=torch.where(upd, a * gap_obs + keep * s.fc_gap, s.fc_gap),
        fc_res=torch.where(upd, a * res_obs + keep * s.fc_res, s.fc_res),
        fc_last_arr=torch.where(upd, t, s.fc_last_arr),
        fc_prev_t=t if enabled is True else torch.where(enabled, t, s.fc_prev_t),
    )

    # the pressure is elementwise: the [E] predictor fields and horizons
    # give each row its own
    f_extra = forecast_pressure(s, const)
    deficit = queued_demand_rows(s) + f_extra - available_rows(s)
    cand = (s.node_job < 0) & (s.node_state == SLEEP)
    sel = _gated(
        cand & (torch.cumsum(cand, dim=-1, dtype=I32) <= deficit[:, None])
        & (f_extra > 0)[:, None],
        enabled,
    )
    s = s._replace(
        node_state=torch.where(sel, SWITCHING_ON, s.node_state),
        node_until=torch.where(sel, t[:, None] + const.t_on, s.node_until),
        n_switch_on=s.n_switch_on + sel.sum(dim=-1, dtype=I32),
    )
    if dvfs_ramp is False:
        return s
    N = s.node_state.shape[-1]
    n_modes = const.dvfs_n_modes  # [E, G]
    fc_mode = torch.minimum(
        n_modes - 1, ((queued_demand_rows(s) + f_extra)[:, None] * n_modes) // N
    )
    target = torch.maximum(s.dvfs_mode, fc_mode.to(I32))
    ramp = f_extra > 0
    for gate in (enabled, dvfs_ramp):
        if gate is not True:
            ramp = ramp & gate
    return apply_dvfs_modes_rows(s, const, target, ramp, terminate_overrun)


# ---------------------------------------------------------------------------
# the declarative policy stacks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PowerPolicy:
    """Base declarative policy: a no-op power manager (never sleeps anything).

    A policy names a point on the traced policy axis via :meth:`params`;
    the engines contain the (flag-gated) rule implementations. Policies are
    hashable frozen dataclasses, so an ``EngineConfig`` remains a valid jit
    cache key; they carry no trace structure except an optional in-graph
    ``controller`` (RL).

    ``dvfs=True`` composes runtime per-group DVFS mode switching (rule 9,
    §DVFS) onto any stack: the queue-pressure ladder by default, agent
    commands under :class:`RLController`. ``forecast=True`` composes the
    EWMA arrival-pressure forecaster (rule 10, §Forecast) the same way —
    proactive wake-ups, plus DVFS pre-ramp when rule 9 is also on.
    """

    dvfs: bool = False
    forecast: bool = False

    @property
    def eager_ready(self) -> bool:
        """True: scheduling treats every non-ACTIVE node as ready at t."""
        return True

    def flags(self) -> dict:
        """Rule-enable flags this stack contributes (see PolicyParams)."""
        return dict(
            sleep_enabled=False,
            ipm_enabled=False,
            rl_enabled=False,
            rl_grouped=False,
            dvfs_enabled=self.dvfs,
            dvfs_rl=False,
            forecast_enabled=self.forecast,
            forecast_dvfs=self.forecast and self.dvfs,
        )

    def params(self, base: BasePolicy = BasePolicy.EASY) -> PolicyParams:
        """Lower (base, self) onto the traced policy axis."""
        return PolicyParams(
            backfill=(BasePolicy(base) == BasePolicy.EASY),
            eager_ready=self.eager_ready,
            **self.flags(),
        )

    def _base_label(self) -> str:
        return "AlwaysOn"

    def psm_label(self) -> str:
        lbl = self._base_label()
        if self.dvfs:
            lbl += "+DVFS"
        if self.forecast:
            lbl += "+Forecast"
        return lbl


@dataclasses.dataclass(frozen=True)
class AlwaysOn(PowerPolicy):
    """Classic always-on baseline: nodes never sleep (legacy PSM ``NONE``)."""


@dataclasses.dataclass(frozen=True)
class DVFS(PowerPolicy):
    """Queue-pressure DVFS ladder on always-on nodes (rule 9, §DVFS): each
    decision point sets every group's mode to
    ``min(n_modes - 1, demand * n_modes // N)`` — slowest when the queue is
    empty, fastest when demand saturates the cluster. Compose DVFS onto a
    sleeping stack with e.g. ``TimeoutSleep(dvfs=True)`` ("PSUS+DVFS")."""

    dvfs: bool = True

    def psm_label(self) -> str:
        return "DVFS+Forecast" if self.forecast else "DVFS"


@dataclasses.dataclass(frozen=True)
class TimeoutSleep(PowerPolicy):
    """Idle-timeout switch-off (legacy PSUS / PSAS).

    ``transition_aware=False`` (PSUS): scheduling ignores power states — jobs
    simply wait for rule-5 wake-ups. ``transition_aware=True`` (PSAS
    "Auto On"): ready times account for transition delays (the SEMANTICS.md
    variant table's right column).
    """

    transition_aware: bool = False

    @property
    def eager_ready(self) -> bool:
        return not self.transition_aware

    def flags(self) -> dict:
        return {**super().flags(), "sleep_enabled": True}

    def _base_label(self) -> str:
        return "PSAS(AutoOn)" if self.transition_aware else "PSUS"


@dataclasses.dataclass(frozen=True)
class IPM(TimeoutSleep):
    """TimeoutSleep + intelligent power management (legacy PSAS+IPM):
    switch-offs are capped by queued demand and sleeping nodes are woken
    proactively when demand exceeds available capacity."""

    transition_aware: bool = True

    def flags(self) -> dict:
        return {**super().flags(), "ipm_enabled": True}

    def _base_label(self) -> str:
        return "PSAS+IPM"


@dataclasses.dataclass(frozen=True)
class Forecast(PowerPolicy):
    """EWMA arrival-pressure forecaster (rule 10, §Forecast) as a
    standalone stack: proactive wake-ups on otherwise always-on nodes.
    Compose it onto a reactive stack with ``"<PSM>+Forecast"`` labels
    (e.g. ``"EASY PSUS+Forecast"`` = ``TimeoutSleep(forecast=True)``),
    exactly like ``"+DVFS"``.

    ``horizon``/``alpha`` are *defaults* for the traced EngineConst
    operands: ``EngineConfig.forecast_horizon``/``forecast_alpha`` win when
    set, and horizon sweeps override per scenario (the numbers ride the
    traced axis; only the ``forecast`` enable flag is policy structure,
    mirroring how ``TimeoutSleep`` declares rule 6 while ``timeout``
    carries the number).
    """

    forecast: bool = True
    horizon: Optional[int] = None
    alpha: Optional[float] = None

    def psm_label(self) -> str:
        return "DVFS+Forecast" if self.dvfs else "Forecast"


@dataclasses.dataclass(frozen=True)
class RLController(PowerPolicy):
    """Agent-controlled power commands (legacy PSM ``RL``).

    ``grouped=False``: commands are global counts (sum over the ``[G]``
    command vectors) — the checkpoint-compatible default. ``grouped=True``:
    commands target node groups individually (see ``apply_rl_commands``).

    ``controller``: optional in-graph policy ``f(s, const) -> (on[G], off[G])``
    — or ``(on[G], off[G], mode[G])`` when ``dvfs=True`` (mode -1 = no
    change) — evaluated inside the engine's power step; this is how a
    checkpointed network drives ``run_sim`` end-to-end as one compiled
    program (``launch/sim.py``). When None, pending commands set externally
    (the RL env path) are applied. The controller is the one piece of policy
    structure that stays *static*: a network cannot be a traced flag.

    ``dvfs=True`` ("RL:dvfs"): rule 9's per-group modes come from the
    agent's mode commands instead of the queue-pressure ladder.
    """

    grouped: bool = False
    controller: Optional[Callable] = None

    def flags(self) -> dict:
        return {
            **super().flags(),
            "rl_enabled": True,
            "rl_grouped": self.grouped,
            "dvfs_rl": self.dvfs,
        }

    def psm_label(self) -> str:
        base = "RL:groups" if self.grouped else "RL"
        if self.dvfs:
            base = "RL:dvfs" if not self.grouped else f"{base}+DVFS"
        return f"{base}+Forecast" if self.forecast else base


# ---------------------------------------------------------------------------
# deprecation shim: PSMVariant <-> PowerPolicy
# ---------------------------------------------------------------------------

_PSM_TO_POLICY = {
    PSMVariant.NONE: AlwaysOn(),
    PSMVariant.PSUS: TimeoutSleep(),
    PSMVariant.PSAS: TimeoutSleep(transition_aware=True),
    PSMVariant.PSAS_IPM: IPM(),
    PSMVariant.RL: RLController(),
}


def policy_from_psm(psm: PSMVariant) -> PowerPolicy:
    """Legacy ``EngineConfig(psm=...)`` -> the equivalent policy stack."""
    return _PSM_TO_POLICY[PSMVariant(psm)]


def psm_of(policy: PowerPolicy) -> Optional[PSMVariant]:
    """Best-effort reverse map (None for policies with no legacy twin)."""
    if getattr(policy, "dvfs", False) or getattr(policy, "forecast", False):
        return None  # runtime DVFS / forecast postdate the PSMVariant enum
    if isinstance(policy, RLController):
        return PSMVariant.RL
    if isinstance(policy, IPM):
        return PSMVariant.PSAS_IPM
    if isinstance(policy, TimeoutSleep):
        return (
            PSMVariant.PSAS if policy.transition_aware else PSMVariant.PSUS
        )
    if isinstance(policy, AlwaysOn):
        return PSMVariant.NONE
    return None


# ---------------------------------------------------------------------------
# scheduler-label registry (single source of truth for launch/benchmarks)
# ---------------------------------------------------------------------------

_BASE_TOKENS = {"FCFS": BasePolicy.FCFS, "EASY": BasePolicy.EASY}
_PSM_TOKENS = {
    "PSUS": TimeoutSleep(),
    "PSAS": TimeoutSleep(transition_aware=True),
    "PSAS(AUTOON)": TimeoutSleep(transition_aware=True),  # alias
    "PSAS+IPM": IPM(),
    "ALWAYSON": AlwaysOn(),
    "DVFS": DVFS(),
    "FORECAST": Forecast(),
    "RL": RLController(),
    "RL:GROUPS": RLController(grouped=True),
    "RL:DVFS": RLController(dvfs=True),
}
_CANONICAL_PSM = ("PSUS", "PSAS", "PSAS+IPM", "AlwaysOn")
_CANONICAL_RL = ("RL", "RL:groups")
_CANONICAL_DVFS = ("DVFS",)
_CANONICAL_FORECAST = ("Forecast", "PSUS+Forecast")


def _resolve_psm_token(token: str) -> Optional[PowerPolicy]:
    psm = _PSM_TOKENS.get(token)
    if psm is not None:
        return psm
    # generic rule composition: "<PSM>+DVFS" / "<PSM>+Forecast" turn rules
    # 9 / 10 on over any registered stack, recursively so the suffixes
    # stack in either order ("PSUS+DVFS+FORECAST", "PSAS+IPM+FORECAST+DVFS")
    for suffix, field in (("+DVFS", "dvfs"), ("+FORECAST", "forecast")):
        if token.endswith(suffix):
            base = _resolve_psm_token(token[: -len(suffix)])
            if base is not None:
                return dataclasses.replace(base, **{field: True})
    return None


def from_label(label: str) -> Tuple[BasePolicy, PowerPolicy]:
    """Parse ``"<FCFS|EASY> <PSM>"`` into a (base, policy) pair.

    PSM tokens: PSUS | PSAS | PSAS(AutoOn) | PSAS+IPM | AlwaysOn | DVFS |
    Forecast | RL | RL:groups | RL:dvfs, plus ``<PSM>+DVFS`` /
    ``<PSM>+Forecast`` suffixes (stackable, either order) for any of them
    (case-insensitive).
    """
    parts = label.split()
    if len(parts) == 2 and parts[0].upper() in _BASE_TOKENS:
        psm = _resolve_psm_token(parts[1].upper())
        if psm is not None:
            return _BASE_TOKENS[parts[0].upper()], psm
    known = scheduler_labels(
        include_rl=True, include_dvfs=True, include_forecast=True
    )
    raise KeyError(
        f"unknown scheduler label {label!r}{did_you_mean(label, known)}; "
        f"expected one of {', '.join(known)} "
        "(alias: 'PSAS(AutoOn)' for PSAS; '<PSM>+DVFS' / '<PSM>+Forecast' "
        "compose rules 9 / 10 onto any stack)"
    )


def scheduler_labels(
    include_rl: bool = False,
    include_dvfs: bool = False,
    include_forecast: bool = False,
) -> Tuple[str, ...]:
    """Canonical labels, in the order the paper's figures use."""
    psms = (
        _CANONICAL_PSM
        + (_CANONICAL_DVFS if include_dvfs else ())
        + (_CANONICAL_FORECAST if include_forecast else ())
        + (_CANONICAL_RL if include_rl else ())
        + (("RL:dvfs",) if include_rl and include_dvfs else ())
    )
    return tuple(
        f"{base} {psm}" for psm in psms for base in ("FCFS", "EASY")
    )


def label_of(base: BasePolicy, policy: PowerPolicy) -> str:
    b = "FCFS" if base == BasePolicy.FCFS else "EASY"
    p = policy.psm_label().replace("PSAS(AutoOn)", "PSAS")
    return f"{b} {p}"
