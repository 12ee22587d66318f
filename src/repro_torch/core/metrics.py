"""Metrics extraction from a finished SimState (host-side) — the counterpart
of the reference's ``core/metrics.py``, field for field."""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from repro_torch.core.convert import state_to_arrays
from repro_torch.core.engine import SimState
from repro_torch.core.types import ACTIVE, DONE, IDLE, SWITCHING_OFF, SWITCHING_ON, SimMetrics
from repro_torch.workloads.platform import PlatformSpec

# numpy arrays of a state, keyed by field (copied to the host)
np_state = state_to_arrays


def _active_powers_and_names(power_active, n_groups):
    """Normalize the second argument of metrics_from_state: the legacy
    scalar active-watts, a per-group sequence, or a PlatformSpec (which
    also supplies group names)."""
    if isinstance(power_active, PlatformSpec):
        return power_active.group_active_powers(), power_active.group_names()
    if np.ndim(power_active) == 0:
        return (float(power_active),) * n_groups, ()
    return tuple(float(p) for p in power_active), ()


def _dvfs_active_node_seconds(mode_energy, dvfs_watts):
    """Active node-seconds from the DVFS ledgers: each ACTIVE node accrued
    ``watts[g, m] * dt`` into ``mode_energy[g, m]``, so each cell divided by
    its own mode draw gives its node-seconds (a zero-watt mode cannot be
    recovered from energy and counts 0). Dividing ACTIVE energy by the base
    draw is wrong as soon as a non-identity mode table ran."""
    me = np.asarray(mode_energy, np.float64)
    watts = np.asarray(dvfs_watts, np.float64)
    return float((me / np.where(watts > 0, watts, np.inf)).sum())


def metrics_from_state(
    s: SimState,
    power_active: Union[float, Sequence[float], PlatformSpec],
) -> SimMetrics:
    """Compute SimMetrics (same field semantics as the Python oracle).

    ``power_active`` recovers active node-seconds from active-state energy;
    pass the PlatformSpec (or a per-group sequence) for heterogeneous
    platforms so each group's energy is divided by its own draw. When a
    DVFS policy ran (the mode-residency ledger is non-zero) and the
    PlatformSpec is given, utilization uses the per-mode ledger division
    of :func:`_dvfs_active_node_seconds` instead.
    """
    s = np_state(s)
    exists = s["job_exists"]
    started = (s["job_start"] >= 0) & exists
    waits = (s["job_start"] - s["job_subtime"])[started]
    done = (s["job_status"] == DONE) & exists
    makespan = int(s["job_finish"][done].max()) if done.any() else 0
    energy_g = s["energy"].astype(np.float64)  # [G, 5]
    energy = energy_g.sum(axis=0)  # per-state totals
    total = float(energy.sum())
    wasted = float(energy[IDLE] + energy[SWITCHING_ON] + energy[SWITCHING_OFF])
    G = energy_g.shape[0]
    powers, names = _active_powers_and_names(power_active, G)
    dvfs_ran = float(s["mode_time"].sum()) > 0.0
    util = 0.0
    if makespan > 0:
        if dvfs_ran and isinstance(power_active, PlatformSpec):
            _, dvfs_watts, _ = power_active.group_dvfs_tables()
            active_node_s = _dvfs_active_node_seconds(
                s["mode_energy"], dvfs_watts
            )
        else:
            active_node_s = sum(
                energy_g[g, ACTIVE] / powers[g] for g in range(G) if powers[g]
            )
        util = float(active_node_s / (s["node_state"].shape[0] * makespan))
    return SimMetrics(
        total_energy_j=total,
        wasted_energy_j=wasted,
        energy_by_state_j=tuple(energy.tolist()),
        mean_wait_s=float(waits.mean()) if waits.size else 0.0,
        max_wait_s=float(waits.max()) if waits.size else 0.0,
        utilization=util,
        makespan_s=makespan,
        n_jobs=int(exists.sum()),
        n_terminated=int((s["job_terminated"] & done).sum()),
        energy_by_group_j=tuple(tuple(row) for row in energy_g.tolist()),
        group_names=names,
        mode_residency_s=tuple(
            tuple(row) for row in s["mode_time"].astype(np.float64).tolist()
        ),
        energy_by_mode_j=tuple(
            tuple(row) for row in s["mode_energy"].astype(np.float64).tolist()
        ),
        truncated=bool(s["truncated"]),
    )


def schedule_table(s: SimState) -> np.ndarray:
    """(n_jobs, 3) [start, finish(-1 if not done), terminated] — parity format
    matching PyDES.schedule_table()."""
    d = np_state(s)
    exists = d["job_exists"]
    start = d["job_start"].astype(np.float64)
    finish = np.where(d["job_status"] == DONE, d["job_finish"], -1).astype(np.float64)
    term = d["job_terminated"].astype(np.float64)
    out = np.stack([start, finish, term], axis=-1)
    return out[exists]
