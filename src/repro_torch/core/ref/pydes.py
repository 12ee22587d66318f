"""Heap-ordered sequential Python DES — the Batsim-like reference oracle.

This is the *baseline the paper compares against*: a conventional sequential
discrete-event simulator. It implements core/SEMANTICS.md exactly and serves
as the correctness oracle for the vectorized PyTorch engine (a copy of the
JAX reference's oracle, so ``chip_smoke.py`` can hold the card's schedule
against it without importing the reference package).

``split_simultaneous_events=True`` reproduces the Batsim bug of the paper's
Fig. 1: same-timestamp job completions are delivered to the scheduler one at
a time (separate "messages"), so the scheduler decides on partial
information and schedules can diverge from the atomic-batch semantics.

Float64 time/energy is used here; the vectorized engine uses int32 time +
f32 compensated energy. Parity tests bound the difference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.types import (
    ACTIVE,
    ALLOCATED,
    DONE,
    IDLE,
    INF_TIME,
    RUNNING,
    SLEEP,
    SWITCHING_OFF,
    SWITCHING_ON,
    WAITING,
    EngineConfig,
    SimMetrics,
)
from repro_torch.workloads.platform import PlatformSpec
from repro_torch.workloads.workload import Workload

INF = float(INF_TIME)


@dataclasses.dataclass
class _Node:
    nid: int
    state: int = IDLE
    until: float = INF
    job: int = -1
    idle_since: float = 0.0


@dataclasses.dataclass
class _Job:
    jid: int  # index in submission order
    res: int
    subtime: int
    reqtime: int
    runtime: int  # nominal work at speed 1
    eff_runtime: int  # realized effective runtime (resolved at start)
    terminated: bool
    status: int = WAITING
    start: float = -1.0
    finish: float = INF
    alloc_ready: float = INF  # predicted start recorded at allocation
    speed: float = 1.0  # current effective speed (DVFS rescale anchor, f32)


class PyDES:
    """Sequential reference engine. See module docstring."""

    def __init__(
        self,
        platform: PlatformSpec,
        workload: Workload,
        config: EngineConfig,
        split_simultaneous_events: bool = False,
        rl_policy: Optional[Callable] = None,
        start_state: int = IDLE,
    ):
        self.p = platform
        self.cfg = config
        # the traced policy axis, as concrete host values: the oracle
        # mirrors the engine's flag-gated superset program — a concrete
        # `if flag:` is the sequential spelling of the engine's
        # `jnp.where(flag, ...)` gates (core/SEMANTICS.md §Traced policy
        # axis), so both engines stay bit-exact per scenario
        self.pp = config.policy.params(config.base)
        self.split = split_simultaneous_events
        self.rl_policy = rl_policy
        # per-node platform tables (core/SEMANTICS.md §Heterogeneity);
        # identical semantics to the JAX engine's EngineConst
        self.power = platform.node_power_table()  # f32[N, 5]
        self.t_on = platform.node_t_switch_on()  # i32[N]
        self.t_off = platform.node_t_switch_off()  # i32[N]
        self.speed = platform.node_speed()  # f32[N]
        if config.node_order == "idle-watts":
            self.okey = self.power[:, IDLE]  # f32[N] idle draw
        elif config.node_order == "pack":
            # dynamic packing key, recomputed per scheduler pass (twin of
            # policy.pack_key); the static key is unused
            self.okey = np.zeros(platform.nb_nodes, np.float32)
        else:
            self.okey = platform.node_order_key()  # f32[N]
        self._pack: Optional[np.ndarray] = None  # frozen per-pass pack key
        self.gid = platform.node_group_id()  # i32[N]
        self.n_groups = platform.n_groups()
        # per-group power rows for the grouped-tables accrual (groups are
        # internally uniform by construction — core/tables.py validates the
        # same invariant on the engine side)
        self.group_power = [g.power_table() for g in platform.groups()]
        # runtime DVFS mode tables + state (core/SEMANTICS.md §DVFS)
        self.dvfs_speed, self.dvfs_watts, self.dvfs_n_modes = (
            platform.group_dvfs_tables()
        )
        self.mode = [0] * self.n_groups  # current mode per group
        M = self.dvfs_speed.shape[1]
        self.mode_time = [[0.0] * M for _ in range(self.n_groups)]
        self.mode_energy = [[0.0] * M for _ in range(self.n_groups)]
        # rule 10 (§Forecast) EWMA predictor operands + state; horizon/alpha
        # resolution mirrors engine.make_const exactly (EngineConfig wins
        # for the horizon; a Forecast policy's fields are the fallback
        # defaults), and the inits mirror engine.init_state
        horizon = config.forecast_horizon
        if horizon is None:
            horizon = getattr(config.policy, "horizon", None) or 0
        alpha = getattr(config.policy, "alpha", None)
        if alpha is None:
            alpha = config.forecast_alpha
        self.fc_horizon = int(horizon)
        self.fc_alpha = np.float32(alpha)
        self.fc_gap = np.float32(float(INF_TIME))
        self.fc_res = np.float32(0.0)
        self.fc_last_arr = 0
        self.fc_prev_t = -1

        wl = workload.sorted_by_subtime()
        self.jobs: List[_Job] = []
        for i, j in enumerate(wl.jobs):
            # realized wall time (work / slowest allocated node's speed) and
            # the overrun verdict are resolved at job start; eff_runtime
            # starts as the nominal work
            self.jobs.append(
                _Job(i, j.res, j.subtime, j.reqtime, j.runtime, j.runtime, False)
            )
        self.nodes = [
            _Node(i, state=start_state, idle_since=0.0)
            for i in range(platform.nb_nodes)
        ]
        self.t = 0.0
        self.energy_by_group = [[0.0] * 5 for _ in range(self.n_groups)]
        self.n_batches = 0
        self.truncated = False  # set by run() when the batch cap bites
        self.gantt: List[Tuple[float, float, int, int, int]] = []  # (t0,t1,node,state,job)
        self._gantt_open: Dict[int, Tuple[float, int, int]] = {}
        if config.record_gantt:
            for nd in self.nodes:
                self._gantt_open[nd.nid] = (0.0, nd.state, -1)
        # profiling counters (Table-4-style breakdown)
        self.counters = {
            "sim_advance": 0,
            "scheduling": 0,
            "resource": 0,
            "job_lifecycle": 0,
            "monitoring": 0,
            "timeout_policy": 0,
        }

    @property
    def energy_by_state(self) -> List[float]:
        """Per-state energy summed over node groups (legacy view)."""
        return [
            sum(g[k] for g in self.energy_by_group) for k in range(5)
        ]

    def _eff_speed(self, nid: int) -> np.float32:
        """Node speed under the current DVFS mode (§DVFS); base otherwise."""
        if self.pp.dvfs_enabled:
            g = int(self.gid[nid])
            return np.float32(self.dvfs_speed[g, self.mode[g]])
        return np.float32(self.speed[nid])

    # ---------- ready times (SEMANTICS.md variant table) ----------
    def _ready(self, nd: _Node) -> float:
        if self.pp.eager_ready:
            return self.t
        if nd.state == IDLE:
            return self.t
        if nd.state == SWITCHING_ON:
            return nd.until
        if nd.state == SLEEP:
            return self.t + float(self.t_on[nd.nid])
        if nd.state == SWITCHING_OFF:
            return nd.until + float(self.t_on[nd.nid])
        return INF  # ACTIVE (not eligible anyway)

    def _sort_key(self, nd: _Node):
        """Allocation order (SEMANTICS.md §Heterogeneity): (ready, [key,] nid)."""
        if self.cfg.node_order == "pack":
            return (self._ready(nd), self._pack[nd.nid], nd.nid)
        if self.cfg.node_order != "id":
            return (self._ready(nd), self.okey[nd.nid], nd.nid)
        return (self._ready(nd), nd.nid)

    def _pack_key(self) -> np.ndarray:
        """f32[N] queue-aware packing key — twin of ``policy.pack_key``.

        Fewest-idle groups first; currently-idle unreserved nodes sort
        strictly before sleeping/transitioning ones (N + 1 band offset).
        Frozen for the duration of one scheduler pass.
        """
        N = len(self.nodes)
        counts = [0] * self.n_groups
        for nd in self.nodes:
            if nd.job < 0 and nd.state == IDLE:
                counts[int(self.gid[nd.nid])] += 1
        key = np.zeros(N, np.float32)
        for nd in self.nodes:
            band = 0 if (nd.job < 0 and nd.state == IDLE) else N + 1
            key[nd.nid] = np.float32(counts[int(self.gid[nd.nid])] + band)
        return key

    def _occupancy(self) -> List[List[int]]:
        """[G][5] per-(group, state) node histogram — twin of the engine's
        ``_occupancy`` (core/SEMANTICS.md §Group-indexed tables)."""
        occ = [[0] * 5 for _ in range(self.n_groups)]
        for nd in self.nodes:
            occ[int(self.gid[nd.nid])][nd.state] += 1
        return occ

    def _group_draw(self, occ: List[List[int]]) -> List[List[float]]:
        """[G][5] occupancy-weighted watts (occ · power, DVFS-aware) —
        twin of the engine's ``_group_draw``; f64 here vs the engine's f32
        contraction, so parity is to rounding like the dense path."""
        dvfs_on = self.pp.dvfs_enabled
        draw = [[0.0] * 5 for _ in range(self.n_groups)]
        for g in range(self.n_groups):
            row = self.group_power[g]
            for st in range(5):
                w = float(row[st])
                if dvfs_on and st == ACTIVE:
                    # ACTIVE draw follows the group's DVFS mode (§DVFS)
                    w = float(self.dvfs_watts[g, self.mode[g]])
                draw[g][st] = w * occ[g][st]
        return draw

    def _gantt_mark(self, nd: _Node) -> None:
        if not self.cfg.record_gantt:
            return
        t0, st, job = self._gantt_open[nd.nid]
        if st != nd.state or job != nd.job_for_gantt:
            if self.t > t0:
                self.gantt.append((t0, self.t, nd.nid, st, job))
            self._gantt_open[nd.nid] = (self.t, nd.state, nd.job_for_gantt)

    # ---------- allocation ----------
    def _eligible(self) -> List[_Node]:
        return [nd for nd in self.nodes if nd.job < 0]

    def _partition_select(self, elig_sorted: List[_Node], res: int):
        """Partition-aware pick (SEMANTICS.md §Partition-aware allocation) —
        host twin of the engine's ``_partition_pick`` masked cumsum.

        Scanning the sorted eligible nodes in allocation order, the first
        group to accumulate ``res`` nodes wins (the earliest-completing
        group); its first ``res`` eligible nodes are the allocation.
        Returns None when no single group can hold the job.
        """
        per_group: Dict[int, List[_Node]] = {}
        for nd in elig_sorted:
            g = int(self.gid[nd.nid])
            bucket = per_group.setdefault(g, [])
            if len(bucket) < res:
                bucket.append(nd)
                if len(bucket) == res:
                    return bucket
        return None

    def _try_allocate(
        self, job: _Job, shadow: Optional[float], extra: Optional[int]
    ) -> bool:
        """Allocate per SEMANTICS.md rule 4. shadow/extra set => backfill test."""
        self.counters["resource"] += 1
        elig = self._eligible()
        if len(elig) < job.res:
            return False
        elig.sort(key=self._sort_key)
        if self.cfg.allocation == "partition":
            # §Partition-aware allocation: no cross-group allocations — the
            # job fails to start when no single group fits it
            picked = self._partition_select(elig, job.res)
            if picked is None:
                return False
            chosen = picked
        else:
            chosen = elig[: job.res]
        ready = max(self._ready(nd) for nd in chosen)
        if shadow is not None:
            pred_completion = ready + job.reqtime
            if not (pred_completion <= shadow or job.res <= extra):
                return False
        for nd in chosen:
            nd.job = job.jid
            if nd.state == SLEEP:
                nd.state = SWITCHING_ON
                nd.until = self.t + float(self.t_on[nd.nid])
                self._gantt_mark(nd)
        job.status = ALLOCATED
        job.alloc_ready = ready
        return True

    def _shadow(self, head: _Job) -> Tuple[float, int]:
        """EASY shadow time S and extra count E (SEMANTICS.md)."""
        rel = []
        for nd in self.nodes:
            if nd.job < 0:
                rel.append(self._ready(nd))
            else:
                j = self.jobs[nd.job]
                if j.status == RUNNING:
                    rel.append(j.start + j.reqtime)
                elif j.status == ALLOCATED:
                    rel.append(j.alloc_ready + j.reqtime)
                else:  # DONE shouldn't hold nodes
                    rel.append(self.t)
        rel.sort()
        # head.res can exceed N (an unsatisfiable request); clamp like the
        # JAX engine's out-of-bounds gather does
        S = rel[min(head.res, len(rel)) - 1]
        E = sum(1 for r in rel if r <= S) - head.res
        return S, E

    # ---------- one scheduler pass (rule 4) ----------
    def _scheduler_pass(self) -> None:
        # merge_bursts mirrors the engine's repeat rule exactly: re-run the
        # pass at the same t while it allocated something AND arrived
        # WAITING jobs remain, so a burst wider than the window W drains in
        # one batch. Only the pass repeats — job starts (rule 5) still run
        # once per batch, after it.
        while True:
            self.counters["scheduling"] += 1
            if self.cfg.node_order == "pack":
                self._pack = self._pack_key()  # frozen for this pass
            queue = [
                j
                for j in self.jobs
                if j.status == WAITING and j.subtime <= self.t
            ][: self.cfg.window]
            shadow = extra = None
            n_alloc = 0
            for j in queue:
                if shadow is None:
                    ok = self._try_allocate(j, None, None)
                    if ok:
                        n_alloc += 1
                    elif not self.pp.backfill:  # FCFS: stop at first failure
                        break
                    else:
                        shadow, extra = self._shadow(j)
                else:
                    if self._try_allocate(j, shadow, extra):
                        # S stays fixed for the batch; backfilled job
                        # consumed res of the extra nodes
                        n_alloc += 1
                        extra = max(0, extra - j.res)
            if not self.cfg.merge_bursts or n_alloc == 0:
                return
            if not any(
                j.status == WAITING and j.subtime <= self.t
                for j in self.jobs
            ):
                return

    # ---------- job starts (rule 5) ----------
    def _start_jobs(self) -> None:
        self.counters["job_lifecycle"] += 1
        per_job_ready: Dict[int, int] = {}
        for nd in self.nodes:
            if nd.job >= 0 and nd.state == IDLE:
                per_job_ready[nd.job] = per_job_ready.get(nd.job, 0) + 1
        for jid, cnt in sorted(per_job_ready.items()):
            j = self.jobs[jid]
            if j.status == ALLOCATED and cnt == j.res:
                # realized runtime = work / slowest allocated node; the f32
                # expression is the cross-engine contract (SEMANTICS.md
                # §Heterogeneity) — the JAX engine evaluates the identical
                # float32 ceil, keeping schedule tables bit-exact
                speed_min = min(
                    self._eff_speed(nd.nid)
                    for nd in self.nodes
                    if nd.job == jid
                )
                realized = max(
                    int(np.ceil(np.float32(j.runtime) / speed_min)), 1
                )
                if self.cfg.terminate_overrun:
                    j.eff_runtime = min(realized, j.reqtime)
                    j.terminated = realized > j.reqtime
                else:
                    j.eff_runtime = realized
                    j.terminated = False
                j.speed = speed_min
                j.status = RUNNING
                j.start = self.t
                j.finish = self.t + j.eff_runtime
                for nd in self.nodes:
                    if nd.job == jid:
                        nd.state = ACTIVE
                        nd.until = INF
                        self._gantt_mark(nd)

    # ---------- PSM rules 6-8 ----------
    def _queued_demand(self) -> int:
        return sum(
            j.res
            for j in self.jobs
            if j.status == WAITING and j.subtime <= self.t
        )

    def _timeout_switch_off(self, ipm_cap: bool = False) -> None:
        """Rule 6; ``ipm_cap`` caps switch-offs by queued demand (PSAS+IPM)."""
        self.counters["timeout_policy"] += 1
        timeout = self.cfg.timeout
        if timeout is None:
            return
        cands = [
            nd
            for nd in self.nodes
            if nd.job < 0
            and nd.state == IDLE
            and self.t - nd.idle_since >= timeout
        ]
        cands.sort(key=lambda nd: (nd.idle_since, nd.nid))
        if ipm_cap:
            avail = sum(
                1
                for nd in self.nodes
                if nd.job < 0 and nd.state in (IDLE, SWITCHING_ON)
            )
            surplus = max(0, avail - self._queued_demand())
            cands = cands[:surplus]
        for nd in cands:
            nd.state = SWITCHING_OFF
            nd.until = self.t + float(self.t_off[nd.nid])
            self._gantt_mark(nd)

    def _ipm_wake(self) -> None:
        avail = sum(
            1
            for nd in self.nodes
            if nd.job < 0 and nd.state in (IDLE, SWITCHING_ON)
        )
        deficit = self._queued_demand() - avail
        if deficit <= 0:
            return
        for nd in self.nodes:
            if deficit <= 0:
                break
            if nd.job < 0 and nd.state == SLEEP:
                nd.state = SWITCHING_ON
                nd.until = self.t + float(self.t_on[nd.nid])
                self._gantt_mark(nd)
                deficit -= 1

    def _apply_rl(self, n_on, n_off) -> None:
        """Rule 8: wake lowest-id sleeping; sleep longest-idle unreserved.

        Global mode takes scalar counts (sequences are summed); grouped mode
        (``pp.rl_grouped``) takes ``[G]`` per-group counts and selects
        within each node group independently (core/policy.py).
        """
        grouped = self.pp.rl_grouped
        if grouped:
            # per-group budgets, indexed by the node's group id
            on_budget = [int(v) for v in np.asarray(n_on).reshape(-1)]
            off_budget = [int(v) for v in np.asarray(n_off).reshape(-1)]
        else:
            # global budgets shared by every node (one-element view)
            on_budget = [int(np.sum(n_on))]
            off_budget = [int(np.sum(n_off))]

        def bucket(nd):
            return int(self.gid[nd.nid]) if grouped else 0

        for nd in self.nodes:
            if nd.job < 0 and nd.state == SLEEP and on_budget[bucket(nd)] > 0:
                on_budget[bucket(nd)] -= 1
                nd.state = SWITCHING_ON
                nd.until = self.t + float(self.t_on[nd.nid])
                self._gantt_mark(nd)
        cands = [
            nd for nd in self.nodes if nd.job < 0 and nd.state == IDLE
        ]
        cands.sort(key=lambda nd: (nd.idle_since, nd.nid))
        for nd in cands:
            if off_budget[bucket(nd)] > 0:
                off_budget[bucket(nd)] -= 1
                nd.state = SWITCHING_OFF
                nd.until = self.t + float(self.t_off[nd.nid])
                self._gantt_mark(nd)

    def _apply_dvfs_modes(self, target: List[int]) -> None:
        """Install a per-group mode vector + remaining-work rescale — the
        shared tail of rules 9 and 10.

        Concrete twin of ``policy.apply_dvfs_modes``: the rescale uses the
        identical float32 expression, so schedules stay bit-exact across
        engines.
        """
        for g in range(self.n_groups):
            self.mode[g] = int(target[g])
        # rescale running, non-terminated jobs whose allocation speed changed
        for j in self.jobs:
            if j.status != RUNNING or j.terminated:
                continue
            speed_min = min(
                self._eff_speed(nd.nid)
                for nd in self.nodes
                if nd.job == j.jid
            )
            if speed_min == np.float32(j.speed):
                continue
            rem = np.float32(max(j.finish - self.t, 1.0))
            work = rem * np.float32(j.speed)  # f32 contract expression
            new_rem = max(int(np.ceil(np.float32(work / speed_min))), 1)
            new_finish = self.t + new_rem
            if self.cfg.terminate_overrun:
                cap = j.start + j.reqtime
                if new_finish > cap:
                    new_finish = cap
                    j.terminated = True
            j.finish = float(new_finish)
            j.eff_runtime = int(j.finish - j.start)
            j.speed = speed_min

    def _apply_dvfs(self, mode_cmd=None) -> None:
        """Rule 9 (§DVFS): per-group mode selection; the mode install +
        remaining-work rescale is the shared :meth:`_apply_dvfs_modes` tail.

        Concrete twin of ``policy.apply_dvfs``: the heuristic ladder uses
        the identical integer expression.
        """
        N = len(self.nodes)
        if self.pp.dvfs_rl:
            target = list(self.mode)
            if mode_cmd is not None:
                for g, c in enumerate(np.asarray(mode_cmd).reshape(-1)):
                    if c >= 0:
                        target[g] = int(
                            min(max(int(c), 0), int(self.dvfs_n_modes[g]) - 1)
                        )
        else:
            demand = self._queued_demand()
            target = [
                min(
                    int(self.dvfs_n_modes[g]) - 1,
                    (demand * int(self.dvfs_n_modes[g])) // N,
                )
                for g in range(self.n_groups)
            ]
        self._apply_dvfs_modes(target)

    def _forecast_pressure(self) -> int:
        """Predicted extra node demand over the horizon (rule 10) —
        concrete twin of ``policy.forecast_pressure`` (identical float32
        expressions, so both engines floor the same value)."""
        gap = max(self.fc_gap, np.float32(1.0))
        horizon = np.float32(self.fc_horizon)
        pressure = (horizon / gap) * self.fc_res
        N = len(self.nodes)
        return int(
            min(max(np.floor(pressure), np.float32(0.0)), np.float32(N))
        )

    def _apply_forecast(self) -> None:
        """Rule 10 (§Forecast): EWMA predictor update, proactive wake, and
        the optional DVFS pre-ramp.

        Concrete twin of ``policy.apply_forecast``: the EWMA updates use the
        identical float32 expressions (strict form ``a*obs + (1-a)*ewma``
        from the same inits, so ``alpha=0`` freezes them and the rule is a
        provable no-op), the wake selects lowest-id sleeping nodes exactly
        like the engine's cumsum mask, and the pre-ramp never drops below
        rule 9's current mode.
        """
        t = int(self.t)
        # predictor update (EWMA over this batch's arrival burst)
        newly = [j for j in self.jobs if self.fc_prev_t < j.subtime <= t]
        if newly:
            denom = np.float32(len(newly))
            gap_obs = np.float32(t - self.fc_last_arr) / denom
            res_obs = np.float32(sum(j.res for j in newly)) / denom
            a = self.fc_alpha
            one = np.float32(1.0)
            self.fc_gap = a * gap_obs + (one - a) * self.fc_gap
            self.fc_res = a * res_obs + (one - a) * self.fc_res
            self.fc_last_arr = t
        self.fc_prev_t = t
        # proactive wake fires only on positive predicted pressure — a
        # zero-horizon (or never-updated) predictor must leave the stack
        # bit-exact with its reactive base, not degenerate into IPM
        f_extra = self._forecast_pressure()
        if f_extra <= 0:
            return
        avail = sum(
            1
            for nd in self.nodes
            if nd.job < 0 and nd.state in (IDLE, SWITCHING_ON)
        )
        budget = self._queued_demand() + f_extra - avail
        for nd in self.nodes:  # lowest id first (engine: cumsum <= deficit)
            if budget <= 0:
                break
            if nd.job < 0 and nd.state == SLEEP:
                nd.state = SWITCHING_ON
                nd.until = self.t + float(self.t_on[nd.nid])
                self._gantt_mark(nd)
                budget -= 1
        # DVFS pre-ramp: never below rule 9's current mode
        if not self.pp.forecast_dvfs:
            return
        N = len(self.nodes)
        demand = self._queued_demand() + f_extra
        target = [
            max(
                self.mode[g],
                min(
                    int(self.dvfs_n_modes[g]) - 1,
                    (demand * int(self.dvfs_n_modes[g])) // N,
                ),
            )
            for g in range(self.n_groups)
        ]
        self._apply_dvfs_modes(target)

    # ---------- event machinery ----------
    def _next_time(self) -> float:
        self.counters["sim_advance"] += 1
        cand = [INF]
        for j in self.jobs:
            if j.status == WAITING and j.subtime > self.t:
                cand.append(float(j.subtime))
            elif j.status == RUNNING:
                cand.append(j.finish)
        for nd in self.nodes:
            if nd.state in (SWITCHING_ON, SWITCHING_OFF):
                cand.append(nd.until)
        # policy-axis candidates, mirroring the engine's flag gates:
        # idle-timeout expiries (sleep_enabled) and the RL decision tick
        if self.pp.sleep_enabled and self.cfg.timeout is not None:
            cand.extend(
                nd.idle_since + self.cfg.timeout
                for nd in self.nodes
                if nd.job < 0 and nd.state == IDLE
            )
        if self.pp.rl_enabled and self.cfg.rl_decision_interval:
            cand.append(self.t + self.cfg.rl_decision_interval)
        if self.pp.forecast_enabled and self.fc_horizon > 0:
            # rule 10 review tick (twin of the engine's _time_candidates):
            # re-evaluate the forecast at most one horizon after each batch
            cand.append(self.t + self.fc_horizon)
        # strictly future events only: an expired-but-guard-blocked timeout
        # otherwise wedges the clock (the guard is re-evaluated at every batch)
        nt = min((c for c in cand if c > self.t), default=INF)
        return nt

    def _accrue(self, t_next: float) -> None:
        self.counters["monitoring"] += 1
        dt = t_next - self.t
        if dt <= 0:
            return
        dvfs_on = self.pp.dvfs_enabled
        if self.cfg.grouped_tables:
            # grouped accrual — the contraction occ[G, 5] · power[G, 5]
            # instead of the dense per-node sum
            draw = self._group_draw(self._occupancy())
            for g in range(self.n_groups):
                for st in range(5):
                    self.energy_by_group[g][st] += draw[g][st] * dt
                if dvfs_on:
                    self.mode_energy[g][self.mode[g]] += draw[g][ACTIVE] * dt
        else:
            for nd in self.nodes:
                g = int(self.gid[nd.nid])
                draw = float(self.power[nd.nid, nd.state])
                if dvfs_on and nd.state == ACTIVE:
                    # ACTIVE draw follows the group's DVFS mode (§DVFS)
                    draw = float(self.dvfs_watts[g, self.mode[g]])
                    self.mode_energy[g][self.mode[g]] += draw * dt
                self.energy_by_group[g][nd.state] += draw * dt
        if dvfs_on:
            for g in range(self.n_groups):
                self.mode_time[g][self.mode[g]] += dt

    def _process_batch(self) -> None:
        t = self.t
        # 1. completions
        completed = [j for j in self.jobs if j.status == RUNNING and j.finish <= t]
        if self.split and len(completed) > 1:
            # Batsim bug mode: deliver completions one at a time, running the
            # scheduler between deliveries (paper Fig. 1).
            for j in completed:
                self._complete(j)
                self._transitions(t)
                self._scheduler_pass()
                self._start_jobs()
        else:
            for j in completed:
                self._complete(j)
            self._transitions(t)
        # 3. arrivals are implicit (queue = WAITING & subtime <= t)
        # 4-5. schedule + start
        self._scheduler_pass()
        self._start_jobs()
        # 6-10. power management: the same flag-gated rule sequence as the
        # engine's _power_step (a disabled rule selects no nodes there;
        # here it is simply skipped — identical state either way)
        if self.pp.sleep_enabled:
            self._timeout_switch_off(ipm_cap=self.pp.ipm_enabled)
        if self.pp.ipm_enabled:
            self._ipm_wake()
        mode_cmd = None
        if self.pp.rl_enabled and self.rl_policy is not None:
            cmds = self.rl_policy(self)
            mode_cmd = cmds[2] if len(cmds) > 2 else None
            self._apply_rl(cmds[0], cmds[1])
            self._start_jobs()
        if self.pp.dvfs_enabled:
            self._apply_dvfs(mode_cmd)
        if self.pp.forecast_enabled:
            self._apply_forecast()

    def _complete(self, j: _Job) -> None:
        self.counters["job_lifecycle"] += 1
        j.status = DONE
        for nd in self.nodes:
            if nd.job == j.jid:
                nd.job = -1
                nd.state = IDLE
                nd.until = INF
                nd.idle_since = self.t
                self._gantt_mark(nd)

    def _transitions(self, t: float) -> None:
        for nd in self.nodes:
            if nd.until <= t and nd.state == SWITCHING_ON:
                nd.state = IDLE
                nd.until = INF
                nd.idle_since = t
                self._gantt_mark(nd)
            elif nd.until <= t and nd.state == SWITCHING_OFF:
                nd.state = SLEEP
                nd.until = INF
                self._gantt_mark(nd)
                if nd.job >= 0:  # reserved while shutting down: chain to on
                    nd.state = SWITCHING_ON
                    nd.until = t + float(self.t_on[nd.nid])
                    self._gantt_mark(nd)

    def run(self, max_batches: Optional[int] = None) -> SimMetrics:
        limit = max_batches or self.cfg.max_batches or (
            20 * len(self.jobs) + 10000
        )
        # t=0 batch (arrivals at 0, initial scheduling)
        self._process_batch()
        while True:
            if all(j.status == DONE for j in self.jobs):
                break
            nt = self._next_time()
            if nt >= INF:
                break
            if self.n_batches >= limit:
                # cap hit with future events pending: the same truncation
                # signal the JAX engine's run_sim raises (SimState.truncated)
                self.truncated = True
                break
            self._accrue(nt)
            self.t = nt
            self._process_batch()
            self.n_batches += 1
        return self.metrics()

    # ---------- reporting ----------
    def metrics(self) -> SimMetrics:
        waits = [
            j.start - j.subtime for j in self.jobs if j.start >= 0
        ]
        makespan = max((j.finish for j in self.jobs if j.status == DONE), default=0.0)
        by_state = self.energy_by_state
        util = 0.0
        if makespan > 0:
            if any(sum(m) > 0 for m in self.mode_time):
                # DVFS ran: ACTIVE draw followed the mode table, so recover
                # node-seconds exactly from the per-mode energy ledger (the
                # same expression as metrics_from_state; §DVFS)
                active_node_s = sum(
                    self.mode_energy[g][m] / float(self.dvfs_watts[g, m])
                    for g in range(self.n_groups)
                    for m in range(self.dvfs_watts.shape[1])
                    if float(self.dvfs_watts[g, m]) > 0
                )
            else:
                # active node-seconds recovered per group from its own draw
                active_node_s = sum(
                    g[ACTIVE] / p_active
                    for g, p_active in zip(
                        self.energy_by_group, self.p.group_active_powers()
                    )
                    if p_active
                )
            util = active_node_s / (len(self.nodes) * makespan)
        total = float(sum(by_state))
        wasted = float(
            by_state[IDLE] + by_state[SWITCHING_ON] + by_state[SWITCHING_OFF]
        )
        return SimMetrics(
            total_energy_j=total,
            wasted_energy_j=wasted,
            energy_by_state_j=tuple(by_state),
            mean_wait_s=float(np.mean(waits)) if waits else 0.0,
            max_wait_s=float(np.max(waits)) if waits else 0.0,
            utilization=float(util),
            makespan_s=int(makespan),
            n_jobs=len(self.jobs),
            n_terminated=sum(1 for j in self.jobs if j.terminated and j.status == DONE),
            energy_by_group_j=tuple(tuple(g) for g in self.energy_by_group),
            group_names=self.p.group_names(),
            mode_residency_s=tuple(tuple(m) for m in self.mode_time),
            energy_by_mode_j=tuple(tuple(m) for m in self.mode_energy),
            truncated=self.truncated,
        )

    def schedule_table(self) -> np.ndarray:
        """(n_jobs, 3) array of [start, finish, terminated] in job order."""
        return np.array(
            [
                [j.start, (j.finish if j.status == DONE else -1.0), float(j.terminated)]
                for j in self.jobs
            ]
        )


# gantt needs node.job even when ACTIVE; patch attribute access
def _job_for_gantt(self: _Node) -> int:
    return self.job if self.state == ACTIVE else -1


_Node.job_for_gantt = property(_job_for_gantt)


def run_pydes(
    platform: PlatformSpec,
    workload: Workload,
    config: EngineConfig,
    **kw,
) -> Tuple[SimMetrics, PyDES]:
    des = PyDES(platform, workload, config, **kw)
    m = des.run()
    # flush open gantt intervals
    if config.record_gantt:
        for nd in des.nodes:
            t0, st, job = des._gantt_open[nd.nid]
            if des.t > t0:
                des.gantt.append((t0, des.t, nd.nid, st, job))
    return m, des
