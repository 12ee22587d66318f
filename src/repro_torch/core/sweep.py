"""Batched scenario sweeps on PyTorch — the counterpart of the JAX
reference's ``engine.sweep`` (its ``core/SEMANTICS.md`` §Traced policy axis
and §Batched sweeps).

The reference vmaps ``run_sim`` over K stacked ``EngineConst`` rows whose
``PolicyParams`` are traced bool operands, so a scheduler x policy x
timeout x platform grid is one compiled program. Here the scenario axis is
written out: every tensor of the state and of the tables carries a leading
``[E]`` axis (E = K), the policy flags are ``[E]`` bool tensors, and one
host loop runs every row. The functions keep the reference's names; each
is the batched spelling of the single run's function of the same name in
``core/engine.py``, which stays as it is.

What a sweep runs: FCFS and EASY rows under rules 6-7 (PSUS, PSAS,
PSAS+IPM, AlwaysOn) in one grid, a timeout per row (``None`` = never), a
platform per row (same node, group and DVFS-mode counts), dense and grouped
tables, ``node_order`` "id", "cheap" and "idle-watts", ``allocation="any"``
and the batch cap, with truncation per row. A grid where a row sets rule
8-10 flags, an in-graph controller, ``node_order="pack"``,
``allocation="partition"``, ``merge_bursts`` or more than one device raises
``NotImplementedError`` naming ROADMAP item 8b (:func:`check_supported`).

The port's analogue of the reference's "one compile per grid": one program
per *iteration*, whatever E is. Each iteration of :func:`run_sim` makes

* one host read of ``(next time, done, quiet, n_batches)``, all ``[E]``,
  which decides the loop for every row (a row is live while it is not done,
  its next event is finite and its ``n_batches`` is under the cap; the loop
  ends when no row is live);
* at most one more, in a full batch's scheduler pass: the ``[E, W]`` queue
  windows, the ``[E, W]`` node counts their jobs ask for and the ``[E]``
  unreserved counts (:func:`_scheduler_pass`). From them the host decides
  each row's head phase, where FCFS stops and which backfill attempts can
  be feasible, exactly as the single run does for one row, and runs one
  batched attempt per *step*, step a being every row's a-th attempt: at
  most W batched attempts for the whole grid, as many as the row that
  attempts most. The per-row masks of who attempts what are built on the
  device from the same values the host read, so no host-to-device copy is
  made per attempt;
* one event-kernel launch for the whole grid (:func:`event_horizon`:
  ``event_fuse_occ`` on ``[E, N]`` on the grouped path, ``event_fuse_ledger``
  on the dense single-group path, each on a CUDA device unless
  ``fused_kernel`` says otherwise).

A row stops where its single run stops: it is *frozen* once it is no longer
live, every field kept by ``torch.where(live, new, old)`` (a Kahan add of a
zero delta is not an identity when the compensation is non-zero), so its
``n_batches``, energy and schedule are its own single run's. The quiet body
runs only when every live row is quiet; otherwise the full batch runs on
every row, which on a quiet row equals the quiet body (the reference's
argument, ``engine._quiet_batch``). So each row equals the port's single run
of its scenario bit for bit wherever the two sum the same values in the same
order: on the kernel routes (exact counts times the watts) and the grouped
plain route (exact counts). The dense per-node route sums each row's watts
in one reduction over ``[E, N, G*5]`` where the single run reduces ``[N,
G*5]``; the CPU's reduction adds the nodes in the same order at the test
sizes, and a CUDA reduction may split them otherwise (energy then agrees to
f32 rounding).

The loop needs host reads, so :func:`sweep_async` runs the grid before it
returns; its handle holds the finished batch. An overlap of host and device
across chunks is ROADMAP item 15's.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import (
    EngineConst,
    EventAux,
    PassInputs,
    SimState,
    _clamp_job,
    _fused_kernel_on,
    _kahan_add,
    default_batch_cap,
    init_state,
    make_const,
    trim_window,
)
from repro_torch.core.metrics import metrics_from_state
from repro_torch.core.policy import (
    PowerPolicy,
    from_label,
    ipm_wake_rows,
    stack_params,
    timeout_switch_off_rows,
)
from repro_torch.core.tables import GroupTables
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
    SimMetrics,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import event_fuse
from repro_torch.workloads.platform import PlatformSpec
from repro_torch.workloads.workload import Workload

I32 = torch.int32
F32 = torch.float32
INF = int(INF_TIME)

# rule 8-10 flags a sweep row may not set yet
_LATER_FLAGS = ("rl_enabled", "dvfs_enabled", "forecast_enabled")


# ---------------------------------------------------------------------------
# what a sweep runs
# ---------------------------------------------------------------------------

def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} not ported to the PyTorch sweep yet (ROADMAP Queue 1 item 8b)"
    )


def _resolve_devices(devices, config: EngineConfig, dev: torch.device) -> Optional[int]:
    """The sweep's device count: ``None`` falls back to ``config.devices``;
    ``"all"`` is every visible device of ``dev``'s type; ``None`` overall is
    the unsharded dispatch."""
    if devices is None:
        devices = config.devices
    if devices is None:
        return None
    if devices == "all":
        return torch.cuda.device_count() if dev.type == "cuda" else 1
    d = int(devices)
    if d < 1:
        raise ValueError(f"devices must be >= 1, got {devices!r}")
    return d


def check_supported(config: EngineConfig, devices: Optional[int] = None) -> None:
    """Raise NotImplementedError for a grid structure the sweep does not run
    yet, naming ROADMAP item 8b (``devices`` is the resolved count); the
    single run's refusals (the legacy loop) apply too."""
    later = []
    if devices is not None and devices > 1:
        later.append(f"devices={devices} (sharded sweeps)")
    if getattr(config.policy, "controller", None) is not None:
        later.append("an in-graph controller")
    if config.node_order == "pack":
        later.append('node_order="pack"')
    if config.allocation == "partition":
        later.append('allocation="partition"')
    if config.merge_bursts:
        later.append("merge_bursts")
    if later:
        raise _later(f"sweep({config.label()!r}): {', '.join(later)}")
    engine.check_supported(dataclasses.replace(config, devices=None))


def _check_rows(consts: Sequence[EngineConst]) -> None:
    for i, c in enumerate(consts):
        on = [k for k in _LATER_FLAGS if bool(getattr(c.policy, k))]
        if on:
            raise _later(f"sweep scenario {i}: rule 8-10 flags {on}")


# ---------------------------------------------------------------------------
# scenarios and their stacking
# ---------------------------------------------------------------------------

def _policy_scenario_const(
    base, policy: PowerPolicy, const: EngineConst, config: EngineConfig
) -> EngineConst:
    """Lower a (base, policy) scenario point onto the policy axis. The flags
    stay Python bools until :func:`stack_consts` makes the ``[E]`` tensors,
    so the host knows which rules no row runs."""
    if getattr(policy, "controller", None) is not None and (
        policy.controller is not getattr(config.policy, "controller", None)
    ):
        raise ValueError(
            "sweep scenarios cannot carry their own in-graph RL controller "
            "(a callable is static trace structure, not a traced operand); "
            "set the controller on the sweep's config instead"
        )
    return const._replace(policy=policy.params(base).static())


def _scenario_const(
    scenario,
    base_const: EngineConst,
    platform: PlatformSpec,
    config: EngineConfig,
    device: torch.device,
) -> Tuple[EngineConst, PlatformSpec]:
    """(EngineConst row, PlatformSpec) of one scenario, in the reference's
    forms: an EngineConst, a PlatformSpec, a scheduler label, a PowerPolicy,
    a mapping of them and of raw EngineConst fields, or an int / None
    timeout."""
    if isinstance(scenario, EngineConst):
        return scenario, platform
    if isinstance(scenario, PlatformSpec):
        if (
            scenario.nb_nodes != platform.nb_nodes
            or scenario.n_groups() != platform.n_groups()
            or scenario.n_dvfs_modes() != platform.n_dvfs_modes()
        ):
            raise ValueError(
                "sweep platforms must share node count, group count, and "
                "DVFS mode-table width "
                f"(base {platform.nb_nodes} nodes/{platform.n_groups()} "
                f"groups/{platform.n_dvfs_modes()} modes, scenario "
                f"{scenario.nb_nodes}/{scenario.n_groups()}/"
                f"{scenario.n_dvfs_modes()}); shapes are part of the "
                "compiled program"
            )
        return make_const(scenario, config, device=device), scenario
    if isinstance(scenario, str):  # scheduler label, e.g. "EASY PSAS+IPM"
        b, pol = from_label(scenario)
        return _policy_scenario_const(b, pol, base_const, config), platform
    if isinstance(scenario, PowerPolicy):
        return (
            _policy_scenario_const(config.base, scenario, base_const, config),
            platform,
        )
    if isinstance(scenario, Mapping):
        sc = dict(scenario)
        plat, const = platform, base_const
        if "platform" in sc:
            p = sc.pop("platform")
            if not isinstance(p, PlatformSpec):
                raise TypeError(
                    f"scenario 'platform' must be a PlatformSpec, got {p!r}"
                )
            const, plat = _scenario_const(p, base_const, platform, config, device)
        base, pol = config.base, config.policy
        if "scheduler" in sc:
            base, pol = from_label(sc.pop("scheduler"))
        base = sc.pop("base", base)
        pol = sc.pop("policy", pol)
        const = _policy_scenario_const(base, pol, const, config)
        if "timeout" in sc:
            t = sc.pop("timeout")
            t = INF if t is None else int(t)
            const = const._replace(
                timeout=torch.tensor(t, dtype=I32, device=device)
            )
        if "tables" in sc:
            raise TypeError(
                "sweep scenarios cannot override 'tables' directly — the "
                "grouped tables are derived from the platform "
                "(core/tables.py); pass a PlatformSpec scenario instead"
            )
        unknown = sorted(k for k in sc if k not in EngineConst._fields)
        if unknown:
            raise TypeError(
                f"unknown sweep scenario key(s) {unknown}: expected "
                "scheduler/base/policy/timeout/platform or EngineConst "
                f"fields {EngineConst._fields}"
            )
        over = {}
        for k, v in sc.items():
            ref = getattr(const, k)
            try:
                # the field's dtype and shape now, so a bad value fails here
                # (naming the key) instead of inside the stacking
                over[k] = torch.broadcast_to(
                    torch.as_tensor(np.asarray(v), dtype=ref.dtype, device=device),
                    ref.shape,
                )
            except (TypeError, ValueError, RuntimeError) as e:
                raise TypeError(
                    f"invalid value for sweep scenario key {k!r} "
                    f"(EngineConst field of shape {tuple(ref.shape)}, dtype "
                    f"{ref.dtype}): {e}"
                ) from e
        return const._replace(**over), plat
    if scenario is None or isinstance(scenario, (int, np.integer)):
        t = INF if scenario is None else int(scenario)
        return (
            base_const._replace(timeout=torch.tensor(t, dtype=I32, device=device)),
            platform,
        )
    raise TypeError(
        f"unsupported sweep scenario {scenario!r}: expected an int timeout, "
        "None, a scheduler label, a PowerPolicy, a PlatformSpec, an "
        "EngineConst, or a mapping of scenario overrides"
    )


def _stack(name: str, xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``[E, ...]``: an expanded view when every row holds the same tensor
    (a shared table costs no copy), else the rows stacked."""
    first = xs[0]
    if all(x is first for x in xs):
        first = first.to(device)
        return first.unsqueeze(0).expand(len(xs), *first.shape)
    try:
        return torch.stack([x.to(device) for x in xs])
    except RuntimeError as e:
        raise ValueError(
            f"sweep rows disagree on the shape of {name!r}: "
            f"{sorted({tuple(x.shape) for x in xs})}"
        ) from e


def stack_consts(rows: Sequence[EngineConst], device: DeviceLike = None) -> EngineConst:
    """K :class:`EngineConst` rows, grouped tables included, as one
    ``EngineConst`` of ``[K, ...]`` tensors on ``device`` whose ``policy``
    holds ``[K]`` bool tensors (the reference's ``jnp.stack`` of the rows)."""
    dev = resolve_device(device)
    grouped = {r.tables is not None for r in rows}
    if len(grouped) != 1:
        raise ValueError("sweep rows mix grouped and dense tables")
    tables = None
    if grouped == {True}:
        tables = GroupTables(*[
            _stack(f"tables.{k}", [getattr(r.tables, k) for r in rows], dev)
            for k in GroupTables._fields
        ])
    return EngineConst(
        policy=stack_params([r.policy for r in rows], dev),
        tables=tables,
        **{
            k: _stack(k, [getattr(r, k) for r in rows], dev)
            for k in EngineConst._fields if k not in ("policy", "tables")
        },
    )


class Grid(NamedTuple):
    """A sweep's stacked tables and what the loop reads of them each batch."""

    const: EngineConst  # [E, ...] tensors; policy: [E] bool tensors
    flags: Dict[str, np.ndarray]  # host copy of each policy flag, [E] bool
    ledger_power: Optional[torch.Tensor]  # f32 [5] or [E, 5] (dense, G == 1)
    group_id: torch.Tensor  # i32 [N] or [E, N]: event_fuse_occ's group ids
    perm: Optional[torch.Tensor]  # i64 [E, N] grouped allocation order

    def gate(self, name: str):
        """Row gate of a flag: ``True`` (every row), ``False`` (no row) or
        its ``[E]`` bool tensor."""
        v = self.flags[name]
        if v.all():
            return True
        if not v.any():
            return False
        return getattr(self.const.policy, name)


def make_grid(rows: Sequence[EngineConst], device: DeviceLike = None) -> Grid:
    """Stack the rows (:func:`stack_consts`) and lay out the event kernels'
    tables once: a table every row shares stays one table (the kernels'
    stride-0 form)."""
    dev = resolve_device(device)
    const = stack_consts(rows, dev)
    flags = {
        k: np.asarray([bool(getattr(r.policy, k)) for r in rows])
        for k in const.policy._fields
    }
    shared = {k: all(getattr(r, k) is getattr(rows[0], k) for r in rows)
              for k in ("power", "group_id")}
    ledger_power = None
    if const.tables is None and const.dvfs_speed.shape[1] == 1:
        ledger_power = (
            rows[0].power[0].to(dev).contiguous() if shared["power"]
            else const.power[:, 0].contiguous()
        )
    group_id = (
        rows[0].group_id.to(dev).contiguous() if shared["group_id"]
        else const.group_id.contiguous()
    )
    perm = None if const.tables is None else const.tables.perm.long().contiguous()
    return Grid(const, flags, ledger_power, group_id, perm)


def replicate_state(s: SimState, e: int) -> SimState:
    """The reference's ``in_axes=None`` initial state as ``[E, ...]``
    tensors: every row a copy of ``s`` (dtypes kept)."""
    return SimState(*[x.unsqueeze(0).repeat(e, *([1] * x.dim())) for x in s])


# ---------------------------------------------------------------------------
# event-batch phases over [E, ...] (SEMANTICS.md rules 1..7)
# ---------------------------------------------------------------------------

def _ready_times(s: SimState, g: Grid) -> torch.Tensor:
    """i32[E, N]: each row's ready times by its own ``eager_ready`` flag."""
    st = s.node_state
    t = s.t[:, None]
    eager = g.gate("eager_ready")
    if eager is True:
        return torch.where(st == ACTIVE, INF, t)
    t_on = g.const.t_on
    ready = torch.full_like(st, INF)
    ready = torch.where(st == SWITCHING_OFF, s.node_until + t_on, ready)
    ready = torch.where(st == SLEEP, t + t_on, ready)
    ready = torch.where(st == SWITCHING_ON, s.node_until, ready)
    ready = torch.where(st == IDLE, t, ready)
    if eager is False:
        return ready
    return torch.where(eager[:, None], torch.where(st == ACTIVE, INF, t), ready)


def _complete_jobs(s: SimState) -> SimState:
    t = s.t[:, None]
    done_now = (s.job_status == RUNNING) & (s.job_finish <= t)
    nj = s.node_job
    node_of_done = (nj >= 0) & done_now.gather(1, _clamp_job(nj))
    return s._replace(
        job_status=torch.where(done_now, DONE, s.job_status),
        node_job=torch.where(node_of_done, -1, nj),
        node_state=torch.where(node_of_done, IDLE, s.node_state),
        node_until=torch.where(node_of_done, INF, s.node_until),
        node_idle_since=torch.where(node_of_done, t, s.node_idle_since),
        n_completions=s.n_completions + done_now.sum(dim=-1, dtype=I32),
    )


def _complete_transitions(s: SimState, g: Grid) -> SimState:
    t = s.t[:, None]
    on_done = (s.node_state == SWITCHING_ON) & (s.node_until <= t)
    off_done = (s.node_state == SWITCHING_OFF) & (s.node_until <= t)
    chain = off_done & (s.node_job >= 0)  # reserved while shutting down
    node_state = torch.where(on_done, IDLE, s.node_state)
    node_state = torch.where(off_done, SLEEP, node_state)
    node_state = torch.where(chain, SWITCHING_ON, node_state)
    node_until = torch.where(on_done | off_done, INF, s.node_until)
    node_until = torch.where(chain, t + g.const.t_on, node_until)
    return s._replace(
        node_state=node_state,
        node_until=node_until,
        node_idle_since=torch.where(on_done, t, s.node_idle_since),
    )


def _queue_window(s: SimState, W: int) -> torch.Tensor:
    """i32[E, W]: each row's first W WAITING-and-arrived jobs; -1 padding
    (the single run's extra-slot scatter, row by row)."""
    waiting = (s.job_status == WAITING) & (s.job_subtime <= s.t[:, None])
    rank = torch.cumsum(waiting, dim=-1, dtype=I32) - 1
    E, J = waiting.shape
    dev = waiting.device
    dest = torch.where(waiting & (rank < W), rank, W)
    window = torch.full((E, W + 1), -1, dtype=I32, device=dev)
    window.scatter_(
        1, dest.long(), torch.arange(J, dtype=I32, device=dev).expand(E, J)
    )
    return window[:, :W]


def _window_values(s: SimState, W: int):
    window = _queue_window(s, W)
    res = s.job_res.gather(1, _clamp_job(window))
    return window, res, (s.node_job < 0).sum(dim=-1, dtype=I32)


def _pass_inputs(s: SimState, g: Grid, cfg: EngineConfig) -> PassInputs:
    """The single run's hoisted pass inputs, per row: on the grouped path
    ``tables.perm``, re-sorted by ready time on the rows that are not
    eager."""
    if not cfg.grouped_tables:
        return PassInputs(_ready_times(s, g), None, None)
    eager = g.gate("eager_ready")
    if eager is True:
        return PassInputs(None, g.perm, None)
    ready = _ready_times(s, g)
    order = g.perm.gather(
        1, torch.argsort(ready.gather(1, g.perm), dim=-1, stable=True)
    )
    if eager is not False:
        order = torch.where(eager[:, None], g.perm, order)
    return PassInputs(ready, order, None)


class _Step(NamedTuple):
    """Every row's job of one batched attempt, read from the pass's
    per-row tables (no gather of its own)."""

    j: torch.Tensor  # i32[E] job (-1 where the row has none)
    jc: torch.Tensor  # i64[E, 1] the job clamped to an index
    res: torch.Tensor  # i32[E] nodes it asks for
    reqtime: Optional[torch.Tensor]  # i32[E] its walltime (backfill steps only)
    attempt: torch.Tensor  # bool[E] the row attempts
    backfill: Optional[torch.Tensor]  # bool[E] under the EASY test (None: no row)


def _try_allocate(s, g: Grid, cfg, step: _Step, inputs: PassInputs, wake_until,
                  shadow=None, extra=None):
    """One batched attempt: row e tries to allocate job ``step.j[e]`` when
    ``step.attempt[e]``, under the EASY backfill test when
    ``step.backfill[e]``. ``wake_until`` is ``t + t_on`` [E, N], the same
    for every attempt of a pass. Returns (ok [E], state); a row that does
    not attempt, or fails, keeps its state bit for bit. The node choice is
    the single run's, row by row (``engine._try_allocate``)."""
    eligible = s.node_job < 0
    j, jc, res_j = step.j, step.jc, step.res
    E, N = eligible.shape
    if inputs.order is not None:
        order = inputs.order
        es = eligible.gather(1, order)
        sel_sorted = es & (torch.cumsum(es, dim=-1, dtype=I32) <= res_j[:, None])
        if inputs.ready is None:  # every row eager: chosen nodes are ready now
            ready_max = s.t
        else:
            ready_max = torch.where(
                sel_sorted, inputs.ready.gather(1, order), -1
            ).amax(dim=-1)
    else:
        key = torch.where(eligible, inputs.ready, INF)
        if cfg.node_order != "id":
            perm1 = torch.argsort(
                torch.where(eligible, g.const.order_key, float("inf")),
                dim=-1, stable=True,
            )
            order = perm1.gather(
                1, torch.argsort(key.gather(1, perm1), dim=-1, stable=True)
            )
        else:
            order = torch.argsort(key, dim=-1, stable=True)
        sel_sorted = torch.arange(N, device=key.device, dtype=I32) < res_j[:, None]
        ready_max = torch.where(sel_sorted, key.gather(1, order), -1).amax(dim=-1)
    ok = (eligible.sum(dim=-1, dtype=I32) >= res_j) & step.attempt
    if step.backfill is not None:
        pred_completion = ready_max + step.reqtime
        ok = ok & (~step.backfill | (pred_completion <= shadow) | (res_j <= extra))
    # order is a permutation of each row: the scatter writes every node once
    chosen = torch.empty_like(eligible).scatter_(1, order, sel_sorted)
    chosen = chosen & eligible & ok[:, None]
    wake = chosen & (s.node_state == SLEEP)
    okc = ok[:, None]
    new = s._replace(
        node_job=torch.where(chosen, j[:, None], s.node_job),
        node_state=torch.where(wake, SWITCHING_ON, s.node_state),
        node_until=torch.where(wake, wake_until, s.node_until),
        job_status=s.job_status.scatter(
            1, jc, torch.where(okc, ALLOCATED, s.job_status.gather(1, jc))
        ),
        job_alloc_ready=s.job_alloc_ready.scatter(
            1, jc, torch.where(okc, ready_max[:, None], s.job_alloc_ready.gather(1, jc))
        ),
        n_allocs=s.n_allocs + ok.to(I32),
        n_switch_on=s.n_switch_on + wake.sum(dim=-1, dtype=I32),
    )
    return ok, new


def _shadow(s: SimState, head: torch.Tensor, ready: torch.Tensor):
    """EASY shadow time S [E] and extra count X [E] of each row's head job
    ``head`` (i32[E]), from the pass-hoisted ready times."""
    nj = s.node_job
    cj = _clamp_job(nj)
    status = s.job_status.gather(1, cj)
    reqtime = s.job_reqtime.gather(1, cj)
    pred_of_job = torch.where(
        status == RUNNING,
        s.job_start.gather(1, cj) + reqtime,
        torch.where(status == ALLOCATED, s.job_alloc_ready.gather(1, cj) + reqtime,
                    s.t[:, None]),
    )
    rel = torch.where(nj >= 0, pred_of_job, ready)
    rel_sorted = torch.sort(rel, dim=-1).values
    res_h = s.job_res.gather(1, _clamp_job(head)[:, None])[:, 0]
    idx = torch.clamp(res_h - 1, 0, rel.shape[1] - 1)
    S = rel_sorted.gather(1, idx.long()[:, None])[:, 0]
    X = (rel <= S[:, None]).sum(dim=-1, dtype=I32) - res_h
    return S, X


class _PassPlan(NamedTuple):
    """The host's reading of one pass, in *steps*: step a is every row's
    a-th attempt (its heads first, then its backfills, each in window
    order). ``steps`` is the most attempts any row makes; a row's shadow is
    computed at the step of its first backfill (its head count)."""

    steps: int
    backfill_steps: set  # steps at which some row backfills
    shadow_steps: set  # steps at which some row needs its shadow


def _plan_pass(host: List[int], E: int, W: int, live, backfill) -> _PassPlan:
    """The single run's host decisions (``engine._run_pass``) for each live
    row of the read ``host``: [E * W] windows, [E * W] node counts, [E]
    unreserved counts."""
    steps, backfill_steps, shadow_steps = 0, set(), set()
    for e in range(E):
        if not live[e]:
            continue
        win = host[e * W:(e + 1) * W]
        res = host[(E + e) * W:(E + e + 1) * W]
        free = host[2 * E * W + e]
        heads, blocked = 0, None
        for k, (j, r) in enumerate(zip(win, res)):
            if j < 0:
                break
            if r > free:
                blocked = k
                break
            heads += 1
            free -= r
        n_bf = 0
        if blocked is not None and backfill[e]:  # FCFS stops at its blocked head
            n_bf = sum(1 for k in range(blocked + 1, W) if win[k] >= 0 and res[k] <= free)
        if n_bf:
            backfill_steps.update(range(heads, heads + n_bf))
            shadow_steps.add(heads)
        steps = max(steps, heads + n_bf)
    return _PassPlan(steps, backfill_steps, shadow_steps)


def _scheduler_pass(s: SimState, g: Grid, cfg: EngineConfig, live, live_d) -> SimState:
    """Rule 4 for every row: FCFS rows stop at their first blocked head,
    EASY rows backfill behind it (by the ``[E]`` ``backfill`` flag).

    One host read fetches every row's window, the node counts its jobs ask
    for and its unreserved count (:func:`_plan_pass` reads them as the
    single run does one row). The device builds the same decisions as
    ``[E, W]`` masks from the same device values: a row's heads are the
    window prefix whose running sum of node counts fits its unreserved
    nodes, it blocks at the first job past that prefix, and its backfill
    candidates are the later jobs that fit what the heads left. A stable
    sort moves each row's attempted positions to the front, in window
    order, and step a runs every row's a-th attempt as one batched attempt:
    at most W steps for the grid, the most any one row attempts. A row's
    shadow is computed at the step of its first backfill, from its state
    after its heads, gated to the rows whose first backfill is there.
    ``live`` (host) and ``live_d`` (its ``[E]`` tensor, None when every row
    is live) leave frozen rows out.
    """
    W = cfg.window
    E = s.t.shape[0]
    window, res, n_free = _window_values(s, W)
    host = engine._read(window, res, n_free)
    plan = _plan_pass(host, E, W, live, g.flags["backfill"])
    if not plan.steps:
        return s
    valid = window >= 0
    csum = torch.cumsum(torch.where(valid, res, 0), dim=-1, dtype=I32)
    att = valid & (csum <= n_free[:, None])  # the heads
    if live_d is not None:
        att = att & live_d[:, None]
    bf = None
    if plan.backfill_steps:
        n_head = att.sum(dim=-1, dtype=I32)
        free_b = n_free - torch.where(att, res, 0).sum(dim=-1, dtype=I32)
        pos = torch.arange(W, dtype=I32, device=window.device)
        blocked = n_head < valid.sum(dim=-1, dtype=I32)
        bf = (valid & (pos > n_head[:, None]) & (res <= free_b[:, None])
              & blocked[:, None])
        gate = g.gate("backfill")
        if gate is not True:
            bf = bf & gate[:, None]
        if live_d is not None:
            bf = bf & live_d[:, None]
        need_shadow = bf.any(dim=-1)
        head_job = window.gather(1, torch.clamp(n_head, max=W - 1).long()[:, None])[:, 0]
        att = att | bf
    # each row's attempted positions first, in window order
    order = torch.argsort((~att).to(I32), dim=-1, stable=True)
    jobs, att, res = window.gather(1, order), att.gather(1, order), res.gather(1, order)
    jc = _clamp_job(jobs)
    req = None
    if bf is not None:
        bf, req = bf.gather(1, order), s.job_reqtime.gather(1, jc)
    inputs = _pass_inputs(s, g, cfg)
    wake_until = s.t[:, None] + g.const.t_on
    shadow = extra = None
    for a in range(plan.steps):
        if a in plan.shadow_steps:
            ready = inputs.ready if inputs.ready is not None else _ready_times(s, g)
            S, X = _shadow(s, head_job, ready)
            rows = need_shadow & (n_head == a)
            shadow = S if shadow is None else torch.where(rows, S, shadow)
            extra = X if extra is None else torch.where(rows, X, extra)
        bf_a = bf[:, a] if a in plan.backfill_steps else None
        step = _Step(jobs[:, a], jc[:, a:a + 1], res[:, a],
                     None if bf_a is None else req[:, a], att[:, a], bf_a)
        ok, s = _try_allocate(s, g, cfg, step, inputs, wake_until, shadow, extra)
        if bf_a is not None:
            # backfill consumed part of the extra pool
            extra = torch.where(ok & bf_a, extra - step.res, extra)
    return s


def _start_jobs(s: SimState, g: Grid, cfg: EngineConfig) -> SimState:
    E, J = s.job_status.shape
    nj = s.node_job
    cj = _clamp_job(nj)
    contrib = ((s.node_state == IDLE) & (nj >= 0)).to(I32)
    ready_count = torch.zeros((E, J), dtype=I32, device=nj.device).scatter_add_(
        1, cj, contrib
    )
    start = (s.job_status == ALLOCATED) & (ready_count == s.job_res)
    node_starts = (nj >= 0) & start.gather(1, cj)
    # realized wall time = nominal work / slowest allocated node (rules 8-10
    # are off in a sweep, so a node's speed is its base speed)
    src = torch.where(nj >= 0, g.const.speed, float("inf"))
    speed_min = torch.full((E, J), float("inf"), dtype=F32, device=nj.device)
    speed_min = speed_min.scatter_reduce(1, cj, src, reduce="amin", include_self=True)
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
    t = s.t[:, None]
    return s._replace(
        job_status=torch.where(start, RUNNING, s.job_status),
        job_start=torch.where(start, t, s.job_start),
        job_eff=torch.where(start, eff, s.job_eff),
        job_speed=torch.where(start, speed_min, s.job_speed),
        job_terminated=torch.where(start, term, s.job_terminated),
        job_finish=torch.where(start, t + eff, s.job_finish),
        node_state=torch.where(node_starts, ACTIVE, s.node_state),
        node_until=torch.where(node_starts, INF, s.node_until),
        n_starts=s.n_starts + start.sum(dim=-1, dtype=I32),
    )


def _power_step(s: SimState, g: Grid) -> SimState:
    """Rules 6-7 on the rows whose flags ask for them."""
    sleep, ipm = g.gate("sleep_enabled"), g.gate("ipm_enabled")
    if sleep is not False:
        s = timeout_switch_off_rows(s, g.const, sleep, ipm)
    if ipm is not False:
        s = ipm_wake_rows(s, g.const, ipm)
    return s


def process_batch(s: SimState, g: Grid, cfg: EngineConfig, live, live_d) -> SimState:
    """One atomic event batch at each row's ``t`` (rules 1-7)."""
    s = _complete_jobs(s)
    s = _complete_transitions(s, g)
    s = _scheduler_pass(s, g, cfg, live, live_d)
    s = _start_jobs(s, g, cfg)
    s = _power_step(s, g)
    return s._replace(n_batches=s.n_batches + 1)


def _quiet_batch(s: SimState, g: Grid) -> SimState:
    """``engine._quiet_batch`` on every row: transition completions and
    idle-timeout expiries only."""
    s = _complete_transitions(s, g)
    sleep = g.gate("sleep_enabled")
    if sleep is not False:
        t = s.t[:, None]
        cand = (
            (s.node_job < 0)
            & (s.node_state == IDLE)
            & (t - s.node_idle_since >= g.const.timeout[:, None])
        )
        if sleep is not True:
            cand = cand & sleep[:, None]
        s = s._replace(
            node_state=torch.where(cand, SWITCHING_OFF, s.node_state),
            node_until=torch.where(cand, t + g.const.t_off, s.node_until),
            n_switch_off=s.n_switch_off + cand.sum(dim=-1, dtype=I32),
        )
    return s._replace(n_batches=s.n_batches + 1)


# ---------------------------------------------------------------------------
# time advance and accrual
# ---------------------------------------------------------------------------

def _next_transition(s: SimState) -> torch.Tensor:
    trans = (s.node_state == SWITCHING_ON) | (s.node_state == SWITCHING_OFF)
    return torch.where(
        trans & (s.node_until > s.t[:, None]), s.node_until, INF
    ).amin(dim=-1)


def _occupancy(s: SimState, g: Grid) -> torch.Tensor:
    """i32[E, G, 5]: ``engine._occupancy`` of each row (an exact int32
    ``index_add_`` over row-offset cells)."""
    E, N = s.node_state.shape
    G = s.energy.shape[1]
    rows = torch.arange(E, dtype=I32, device=s.t.device)[:, None] * (G * N_STATES)
    cell = (rows + g.const.group_id * N_STATES + s.node_state).long()
    return torch.zeros(E * G * N_STATES, dtype=I32, device=cell.device).index_add_(
        0, cell.reshape(-1), torch.ones(E * N, dtype=I32, device=cell.device)
    ).view(E, G, N_STATES)


def _node_power_draw(s: SimState, g: Grid) -> torch.Tensor:
    """f32[E, N]: each node's draw in its state (DVFS is off in a sweep)."""
    return g.const.power.gather(2, s.node_state.long()[..., None])[..., 0]


def _ledger(s: SimState, g: Grid, node_power: torch.Tensor) -> torch.Tensor:
    """f32[E, G, 5]: ``engine._ledger`` of each row, the nodes summed in
    order (a one-hot sum over the node axis; no float atomics)."""
    E, G = s.energy.shape[:2]
    cell = g.const.group_id * N_STATES + s.node_state
    cells = torch.arange(G * N_STATES, dtype=I32, device=cell.device)
    onehot = cell[..., None] == cells
    return torch.where(onehot, node_power[..., None], 0.0).sum(dim=1).view(
        E, G, N_STATES
    )


def event_horizon(
    s: SimState, g: Grid, cfg: EngineConfig
) -> Tuple[torch.Tensor, EventAux]:
    """``engine.event_horizon`` for every row: next-event times ``[E]``, the
    draw for the coming interval and the quiet classification ``[E]``, with
    ONE event-kernel call for the grid: ``event_fuse_occ`` on the grouped
    path, ``event_fuse_ledger`` on the dense path of a single-group platform
    (DVFS is off in every sweep row), else the per-node route."""
    G = s.energy.shape[1]
    aux_occ = aux_power = aux_draw = None
    t = s.t
    kernel = _fused_kernel_on(cfg, t.device)
    if cfg.grouped_tables:
        if kernel:
            occ8, tr = event_fuse.event_fuse_occ(
                s.node_state, s.node_until, t, g.group_id, G
            )
            aux_occ = occ8[:, :, :N_STATES].to(I32)  # exact integer counts
        else:
            aux_occ = _occupancy(s, g)
            tr = _next_transition(s)
        aux_draw = aux_occ.to(F32) * g.const.tables.power
    elif G == 1 and kernel:
        draw8, tr = event_fuse.event_fuse_ledger(
            s.node_state, s.node_until, t, g.ledger_power
        )
        aux_draw = draw8[:, None, :N_STATES]
    else:
        aux_power = _node_power_draw(s, g)
        tr = _next_transition(s)
    t2 = t[:, None]
    waiting_future = (s.job_status == WAITING) & (s.job_subtime > t2)
    arr = torch.where(waiting_future, s.job_subtime, INF).amin(dim=-1)
    running = s.job_status == RUNNING
    fin = torch.where(running & (s.job_finish > t2), s.job_finish, INF).amin(dim=-1)
    nt = torch.minimum(torch.minimum(arr, fin), tr)
    sleep = g.gate("sleep_enabled")
    if sleep is not False:
        idle_unres = (s.node_job < 0) & (s.node_state == IDLE)
        expiry = s.node_idle_since + g.const.timeout[:, None]
        c = torch.where(idle_unres & (expiry > t2), expiry, INF).amin(dim=-1)
        if sleep is not True:
            c = torch.where(sleep, c, INF)
        nt = torch.minimum(nt, torch.where(c > t, c, INF))
    busy = (
        ((s.job_status == WAITING) & (s.job_subtime <= t2))
        | (s.job_status == ALLOCATED)
    ).any(dim=-1)
    quiet = (arr > nt) & (fin > nt) & ~busy
    return nt, EventAux(node_power=aux_power, draw=aux_draw, occ=aux_occ, quiet=quiet)


def accrue_energy(s: SimState, t_next: torch.Tensor, g: Grid, aux: EventAux) -> SimState:
    """``engine.accrue_energy`` for every row over ``[s.t, t_next)``, from
    the event pass's draw (on the grouped path the occupancy is stored in
    ``occ``). A row that is no longer live is restored by the loop's
    freeze, so each row's fields are its own single run's."""
    dt = torch.clamp(t_next - s.t, min=0).to(F32)
    occ = s.occ
    if aux.occ is not None:
        occ, draw = aux.occ, aux.draw
    elif aux.draw is not None:
        draw = aux.draw
    else:
        draw = _ledger(s, g, aux.node_power)
    e, c = _kahan_add(s.energy, s.energy_c, draw * dt[:, None, None])
    n_waiting = (
        ((s.job_status == WAITING) & (s.job_subtime <= s.t[:, None]))
        | (s.job_status == ALLOCATED)
    ).sum(dim=-1, dtype=F32)
    w, wc = _kahan_add(s.wait_integral, s.wait_c, n_waiting * dt)
    return s._replace(energy=e, energy_c=c, wait_integral=w, wait_c=wc, occ=occ)


def all_done(s: SimState) -> torch.Tensor:
    """bool[E]: every job of the row is DONE."""
    return (s.job_status == DONE).all(dim=-1)


def _freeze(live: torch.Tensor, new: SimState, old: SimState) -> SimState:
    """``new`` on the live rows, ``old`` on the others, field by field (a
    field the batch did not touch is the same tensor and is kept)."""
    return SimState(*[
        n if n is o else torch.where(live.view(-1, *([1] * (n.dim() - 1))), n, o)
        for n, o in zip(new, old)
    ])


def run_sim(s: SimState, g: Grid, cfg: EngineConfig, max_batches: int) -> SimState:
    """Run every row to its own end on the device that holds ``s`` and
    ``g``: the single run's loop (``engine.run_sim``) over ``[E]`` rows, one
    host read per iteration for all of them (module docstring)."""
    s = process_batch(s, g, cfg, [True] * s.t.shape[0], None)
    nt, aux = event_horizon(s, g, cfg)
    E = s.t.shape[0]
    while True:
        done = all_done(s)
        host = engine._read(nt, done, aux.quiet, s.n_batches)
        live = [
            not d and x < INF and b < max_batches
            for x, d, b in zip(host[:E], host[E:2 * E], host[3 * E:])
        ]
        if not any(live):
            break
        live_d = None
        if not all(live):
            live_d = ~done & (nt < INF) & (s.n_batches < max_batches)
        old = s
        s = accrue_energy(s, nt, g, aux)
        s = s._replace(t=nt)
        if all(q for q, l in zip(host[2 * E:3 * E], live) if l):
            s = _quiet_batch(s, g)
        else:
            s = process_batch(s, g, cfg, live, live_d)
        if live_d is not None:
            s = _freeze(live_d, s, old)
        nt, aux = event_horizon(s, g, cfg)
    return s._replace(truncated=~done & (nt < INF))


# ---------------------------------------------------------------------------
# the host API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimBatch:
    """Result of :func:`sweep`: K scenarios run as one batched loop.

    ``states`` is the stacked final :class:`SimState` (leading axis K, on
    the sweep's device); ``metrics[i]`` the i-th scenario's
    :class:`SimMetrics`. ``n_compiles`` is None: nothing is compiled.
    ``cache_hit`` says whether the grid's static key was in the
    :func:`cache_stats` LRU; ``devices`` the resolved device count (None =
    unsharded).
    """

    states: SimState
    metrics: Tuple[SimMetrics, ...]
    n_compiles: Optional[int] = None
    cache_hit: Optional[bool] = None
    devices: Optional[int] = None

    def __len__(self) -> int:
        return len(self.metrics)

    def __getitem__(self, i: int) -> SimMetrics:
        return self.metrics[i]

    def state_at(self, i: int) -> SimState:
        """Row ``i`` as an unbatched :class:`SimState` (views)."""
        return SimState(*[x[i] for x in self.states])

    def rows(self) -> Tuple[dict, ...]:
        return tuple(m.row() for m in self.metrics)


# the grids' static keys (the reference's _SWEEP_FNS keys), a bounded LRU;
# one hit/miss tick per sweep, so a service can report reuse
_SWEEP_KEYS: "OrderedDict" = OrderedDict()
_SWEEP_CACHE_SIZE = 8
_CACHE_STATS = {"sweep_hits": 0, "sweep_misses": 0}


def cache_stats() -> dict:
    """A copy of the sweep cache's hit/miss counters."""
    return dict(_CACHE_STATS)


def _static_trace_key(platform, config, J, cap, device):
    """The reference's static trace key (``engine._static_trace_key``): every
    input that is structure rather than a per-row value."""
    return (
        config.window, config.node_order, config.terminate_overrun,
        getattr(config.policy, "controller", None),
        getattr(config.policy, "dvfs", False),
        config.fused_events, _fused_kernel_on(config, device),
        config.grouped_tables, config.merge_bursts,
        config.allocation,
        config.devices,
        platform.nb_nodes, platform.n_groups(), platform.n_dvfs_modes(),
        J, cap,
    )


def _tick_cache(key) -> bool:
    hit = key in _SWEEP_KEYS
    _CACHE_STATS["sweep_hits" if hit else "sweep_misses"] += 1
    if hit:
        _SWEEP_KEYS.move_to_end(key)
    else:
        if len(_SWEEP_KEYS) >= _SWEEP_CACHE_SIZE:
            _SWEEP_KEYS.popitem(last=False)  # evict least-recently-used
        _SWEEP_KEYS[key] = None
    return hit


@dataclasses.dataclass
class PendingSweep:
    """The handle :func:`sweep_async` returns. The port's loop reads the
    device every iteration, so the grid has already run when the handle is
    made; :meth:`result` builds the :class:`SimBatch` (metrics and the
    truncation warning) once."""

    _out: SimState
    _plats: list
    _cache_hit: bool
    _devices: Optional[int]
    _batch: Optional[SimBatch] = None

    def result(self) -> SimBatch:
        if self._batch is not None:
            return self._batch
        out = self._out
        host = SimState(*[x.cpu() for x in out])  # one copy a field
        trunc = np.flatnonzero(host.truncated.numpy())
        if trunc.size:
            warnings.warn(
                f"sweep scenario(s) {[int(i) for i in trunc]} hit the batch "
                "cap before completing — their rows describe PARTIAL "
                "simulations (SimMetrics.truncated). Raise "
                "EngineConfig.max_batches to run them to completion.",
                RuntimeWarning,
                stacklevel=2,
            )
        metrics = tuple(
            metrics_from_state(SimState(*[x[i] for x in host]), plat)
            for i, plat in enumerate(self._plats)
        )
        self._batch = SimBatch(
            states=out, metrics=metrics, n_compiles=None,
            cache_hit=self._cache_hit, devices=self._devices,
        )
        return self._batch


def sweep_async(
    platform: PlatformSpec,
    workload: Workload,
    scenarios: Sequence[Any],
    config: Optional[EngineConfig] = None,
    job_capacity: Optional[int] = None,
    devices: Optional[Any] = None,
    device: DeviceLike = None,
) -> PendingSweep:
    """:func:`sweep`'s arguments and cache; returns a :class:`PendingSweep`
    whose grid has already run (the loop reads the device every iteration,
    so nothing is left in flight; an overlap across chunks is ROADMAP item
    15's)."""
    dev = resolve_device(device)
    config = trim_window(config or EngineConfig(), len(workload))
    D = _resolve_devices(devices, config, dev)
    check_supported(config, D)
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("sweep needs at least one scenario")
    # the rows run on one device: the single run's tables and loop take
    # the config without its device count
    cfg = dataclasses.replace(config, devices=None)
    base_const = make_const(platform, cfg, device=dev)
    consts, plats = [], []
    for sc in scenarios:
        c, p = _scenario_const(sc, base_const, platform, cfg, dev)
        consts.append(c)
        plats.append(p)
    _check_rows(consts)
    grid = make_grid(consts, dev)
    s0 = init_state(platform, workload, cfg, device=dev, job_capacity=job_capacity)
    cap = config.max_batches or default_batch_cap(len(workload))
    key = _static_trace_key(
        platform, config, int(s0.job_status.shape[0]), cap, dev
    ) + (len(consts), D)
    hit = _tick_cache(key)
    out = run_sim(replicate_state(s0, len(consts)), grid, cfg, cap)
    return PendingSweep(out, plats, hit, D)


def sweep(
    platform: PlatformSpec,
    workload: Workload,
    scenarios: Sequence[Any],
    config: Optional[EngineConfig] = None,
    job_capacity: Optional[int] = None,
    devices: Optional[Any] = None,
    device: DeviceLike = None,
) -> SimBatch:
    """Run K scenarios as ONE batched loop on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``; raises when CUDA is asked for and absent).

    A scenario is a point on the per-row axes of :class:`EngineConst`,
    sharing only ``config``'s structure (window, node_order,
    terminate_overrun, grouped_tables, fused_kernel):

    * an int (timeout override; ``None`` = never),
    * a scheduler label string (``"FCFS PSAS+IPM"``), replacing base *and*
      power policy,
    * a :class:`~repro_torch.core.policy.PowerPolicy` (keeps
      ``config.base``),
    * a :class:`PlatformSpec` with the same node, group and DVFS-mode counts,
    * a mapping combining any of the above under the keys ``scheduler`` /
      ``base`` / ``policy`` / ``timeout`` / ``platform``, plus raw
      :class:`EngineConst` field overrides,
    * or a prebuilt :class:`EngineConst`.

    Each row equals the port's single run (``engine.simulate``) of its
    scenario (module docstring); per-scenario :class:`SimMetrics` come back
    in a :class:`SimBatch`. ``devices``: None, 1 or ``"all"`` on one card;
    more raises naming ROADMAP item 8b.
    """
    return sweep_async(
        platform, workload, scenarios, config, job_capacity=job_capacity,
        devices=devices, device=device,
    ).result()
