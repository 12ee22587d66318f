"""Shared types & constants for the PyTorch engine and its oracle.

A copy of the JAX reference's ``core/types.py`` (semantics in the reference's
``core/SEMANTICS.md``); only the lazy policy import points at this package.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, NamedTuple, Optional

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only (avoids an import cycle)
    from repro_torch.core.policy import PowerPolicy

# node power states (indexing order is part of the engine contract)
SLEEP, SWITCHING_ON, IDLE, ACTIVE, SWITCHING_OFF = 0, 1, 2, 3, 4
N_STATES = 5
STATE_NAMES = ("sleep", "switching_on", "idle", "active", "switching_off")

# job statuses
WAITING, ALLOCATED, RUNNING, DONE = 0, 1, 2, 3

INF_TIME = np.int32(2**30)  # sentinel "never" (headroom for + t_on arithmetic)


def did_you_mean(unknown, known) -> str:
    """``"; did you mean 'x'?"`` error suffix (the config-key validation
    style shared by scheduler labels, DVFS mode names, and spec keys)."""
    import difflib

    close = difflib.get_close_matches(
        str(unknown), [str(k) for k in known], n=1
    )
    return f"; did you mean {close[0]!r}?" if close else ""


class BasePolicy(enum.IntEnum):
    FCFS = 0
    EASY = 1


class PSMVariant(enum.IntEnum):
    """DEPRECATED: the legacy power-management enum.

    Survives only as a constructor shim — ``EngineConfig(psm=...)`` maps onto
    the equivalent composable policy stack (``core/policy.py``). New code
    passes ``EngineConfig(policy=...)`` (or uses ``policy.from_label``).
    """

    NONE = 0  # always-on: nodes never sleep (classic scheduler baseline)
    PSUS = 1
    PSAS = 2  # PSAS (Auto On)
    PSAS_IPM = 3
    RL = 4  # agent-controlled power commands


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (the structure of one engine run).

    Power management is a composable :class:`repro_torch.core.policy.PowerPolicy`
    (``policy=``); the legacy ``psm=`` enum still works as a deprecation shim
    and is kept mirrored from ``policy`` so old readers see a consistent
    value (None for policies with no legacy twin). When both are given,
    ``policy`` wins — ``psm`` is only consulted when ``policy`` is None.
    """

    base: BasePolicy = BasePolicy.EASY
    psm: Optional[PSMVariant] = None  # DEPRECATED constructor shim
    policy: Optional["PowerPolicy"] = None  # default: TimeoutSleep() (PSUS)
    timeout: Optional[int] = None  # idle seconds before switch-off; None = never
    terminate_overrun: bool = False
    window: int = 32  # scheduler scan window W (bounded backfill depth)
    # node selection order for allocation (core/SEMANTICS.md §Heterogeneity):
    #   "id"         — (ready, nid): the homogeneous tie-breaking, O(N) path
    #   "cheap"      — (ready, order_key, nid): active watts per unit work
    #   "idle-watts" — (ready, idle_watts, nid): cheapest-to-leave-idle first
    #   "pack"       — (ready, idle_in_group, nid): queue-aware packing —
    #                  prefer groups with the fewest idle nodes so sparsely
    #                  used groups drain and become whole-group sleepable;
    #                  the key is recomputed once per scheduler pass
    node_order: str = "id"
    # allocation scope (core/SEMANTICS.md §Partition-aware allocation):
    #   "any"       — a job may span node groups (the classic rule 4; its
    #                 realized runtime then binds to the slowest chosen node)
    #   "partition" — cross-group allocations are FORBIDDEN: the job takes
    #                 the earliest-completing single group that can hold all
    #                 res_j nodes (scanning the same (ready, [key,] nid)
    #                 order), and *fails to start* when no group fits —
    #                 rather than binding its realized runtime to the
    #                 slowest node of a mixed allocation. Orthogonal to
    #                 node_order (any ordering composes).
    allocation: str = "any"
    record_gantt: bool = False
    gantt_capacity: int = 0  # 0 -> auto
    max_batches: Optional[int] = None  # safety cap; None -> auto
    rl_decision_interval: Optional[int] = None  # RL: also wake every Δ seconds
    # hot-loop structure (core/SEMANTICS.md §Hot loop). ``fused_events``
    # selects the fused per-iteration event pass (one read of the node
    # arrays for next-event time + power draw, carried across the while
    # loop, with quiet-event batching and the early-exit scheduler scan);
    # False restores the legacy loop — bit-exact either way, kept as a
    # benchmarkable baseline. ``fused_kernel`` routes the fused pass
    # through the ``event_fuse_ledger`` kernel (None = auto: the CUDA kernel
    # on a CUDA device, its plain PyTorch version on the CPU; False = the
    # per-node draw route).
    fused_events: bool = True
    fused_kernel: Optional[bool] = None
    # group-indexed tables (core/SEMANTICS.md §Group-indexed tables):
    # lower the platform to per-group arrays (core/tables.py) and carry a
    # [G, 5] occupancy histogram in SimState so energy accrual and the
    # fused event pass do O(G) work instead of O(N), and the scheduler
    # pass hoists its node order out of the per-attempt loop. Schedule
    # bit-exact vs the dense path; energy agrees to f32 rounding (count x
    # power contraction vs per-node scatter-add). False keeps the dense
    # per-node path — the bit-exact baseline.
    grouped_tables: bool = False
    # merge same-timestamp arrival bursts (§Hot loop): when one timestamp
    # carries more newly-runnable jobs than the window W, repeat the
    # scheduler pass at the same t while it makes progress (and arrived
    # WAITING jobs remain) so the whole burst is scheduled in one batch.
    # Fused and legacy loops are bit-exact per label with the flag on, and
    # the oracle mirrors the same repeat rule. Vs merge_bursts=False the
    # *schedule itself* can differ (improve): without the merge, next_time
    # is strictly future, so the burst's tail past W waits for the next
    # unrelated event before it is even scanned.
    merge_bursts: bool = False
    # rule 10 (core/SEMANTICS.md §Forecast): EWMA arrival-pressure predictor
    # horizon in seconds. Like ``timeout``/``rl_decision_interval`` these
    # lower to *traced* EngineConst operands, so a forecast-horizon sweep
    # rides the one-compile grid; whether the rule runs at all is the
    # policy stack's ``forecast`` flag (``"<PSM>+Forecast"`` labels).
    # None lowers to 0 — an enabled Forecast with a zero horizon predicts
    # zero pressure and is bit-exact with its reactive base.
    forecast_horizon: Optional[int] = None
    forecast_alpha: float = 0.25  # EWMA smoothing weight in [0, 1]
    # device sharding of the sweep scenario axis (core/SEMANTICS.md
    # §Device-sharded sweeps): the default device count `engine.sweep`
    # lowers its stacked scenario batch onto (a 1-D mesh via shard_map).
    # None = unsharded single-device dispatch (the legacy jit(vmap) path);
    # an int D shards across the first D local devices; "all" takes
    # jax.device_count(). Per-scenario results are bit-exact regardless —
    # sharding only changes placement, never semantics.
    devices: Optional[object] = None

    NODE_ORDERS = ("id", "cheap", "idle-watts", "pack")
    ALLOCATIONS = ("any", "partition")

    def __post_init__(self):
        if self.node_order not in self.NODE_ORDERS:
            raise ValueError(
                f"node_order must be one of {self.NODE_ORDERS}, "
                f"got {self.node_order!r}"
            )
        if self.allocation not in self.ALLOCATIONS:
            raise ValueError(
                f"allocation must be one of {self.ALLOCATIONS}, "
                f"got {self.allocation!r}"
            )
        if self.devices is not None and self.devices != "all":
            if not isinstance(self.devices, int) or self.devices < 1:
                raise ValueError(
                    'devices must be None, a positive int, or "all", '
                    f"got {self.devices!r}"
                )
        if not 0.0 <= self.forecast_alpha <= 1.0:
            raise ValueError(
                f"forecast_alpha must be in [0, 1], got {self.forecast_alpha!r}"
            )
        if self.forecast_horizon is not None and self.forecast_horizon < 0:
            raise ValueError(
                f"forecast_horizon must be >= 0, got {self.forecast_horizon!r}"
            )
        from repro_torch.core.policy import policy_from_psm, psm_of

        if self.policy is None:
            psm = PSMVariant.PSUS if self.psm is None else self.psm
            object.__setattr__(self, "policy", policy_from_psm(psm))
        # policy takes precedence when both are given: psm is only a
        # constructor shim, and it is auto-mirrored below — so
        # dataclasses.replace(cfg, policy=...) must not see the source
        # config's mirrored psm as a conflicting user input
        object.__setattr__(self, "psm", psm_of(self.policy))

    @property
    def timeout_or_inf(self) -> int:
        return int(INF_TIME) if self.timeout is None else int(self.timeout)

    @property
    def forecast_horizon_or_zero(self) -> int:
        return 0 if self.forecast_horizon is None else int(self.forecast_horizon)

    def label(self) -> str:
        base = "FCFS" if self.base == BasePolicy.FCFS else "EASY"
        return f"{base} {self.policy.psm_label()}"


class SimMetrics(NamedTuple):
    """Aggregate metrics (identical field meaning across both engines)."""

    total_energy_j: float
    wasted_energy_j: float
    # spars-lint: ignore[SL006, PL006] legacy per-state view, summarized by the
    # total/wasted columns; row() stays golden-file stable without it
    energy_by_state_j: tuple  # len 5, ordered by state id
    mean_wait_s: float
    max_wait_s: float
    utilization: float
    makespan_s: int
    n_jobs: int
    n_terminated: int
    # per node-group 5-tuples (group order matches PlatformSpec.groups());
    # a homogeneous platform has exactly one group == energy_by_state_j
    energy_by_group_j: tuple = ()
    group_names: tuple = ()
    # runtime DVFS ledgers (core/SEMANTICS.md §DVFS): per group x mode
    # residency seconds and ACTIVE-state energy attributed to the mode the
    # group was in while it accrued. All-zero when no DVFS policy ran.
    mode_residency_s: tuple = ()
    energy_by_mode_j: tuple = ()
    # True when the run hit its batch/log cap before completing: every
    # other field then describes a PARTIAL simulation, not a finished one
    truncated: bool = False

    def _group_labels(self, n: int) -> list:
        names = list(self.group_names) + [
            f"group{i}" for i in range(len(self.group_names), n)
        ]
        # duplicate group names would collide as dict keys and silently
        # drop groups; qualify repeats with their group index
        return [
            nm if names.count(nm) == 1 else f"{nm}{i}"
            for i, nm in enumerate(names)
        ]

    def row(self) -> dict:
        out = {
            "total_energy_kwh": self.total_energy_j / 3.6e6,
            "wasted_energy_kwh": self.wasted_energy_j / 3.6e6,
            "mean_wait_s": self.mean_wait_s,
            "max_wait_s": self.max_wait_s,
            "utilization": self.utilization,
            "makespan_s": self.makespan_s,
            "n_jobs": self.n_jobs,
            "n_terminated": self.n_terminated,
        }
        # only surfaced when it bites: a finished run keeps its legacy
        # column set (deterministic CSV/JSON goldens), a capped run is loud
        if self.truncated:
            out["truncated"] = True
        if len(self.energy_by_group_j) > 1:
            names = self._group_labels(len(self.energy_by_group_j))
            for name, e in zip(names, self.energy_by_group_j):
                out[f"energy_kwh.{name}"] = float(sum(e)) / 3.6e6
        # DVFS columns only when a DVFS policy actually ran (residency
        # accrues only under dvfs_enabled) and there is a real mode choice
        modes = self.mode_residency_s
        if modes and any(sum(m) > 0 for m in modes) and max(
            len(m) for m in modes
        ) > 1:
            names = self._group_labels(len(modes))
            for name, res, e in zip(names, modes, self.energy_by_mode_j):
                for k, (r_s, e_j) in enumerate(zip(res, e)):
                    out[f"mode_s.{name}.m{k}"] = float(r_s)
                    out[f"mode_kwh.{name}.m{k}"] = float(e_j) / 3.6e6
        return out
