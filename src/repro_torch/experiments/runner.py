"""Evaluate an :class:`Experiment` on PyTorch — the counterpart of the
reference's ``experiments/runner.py``.

``run(experiment)`` resolves the spec, builds the scheduler x timeout
[x forecast] [x platform] scenario grid and runs it through the batched
sweep (``core/sweep.py``): every grid point is a row of one ``[E]`` loop,
one replication at a time. A single-point grid (1 scheduler x 1 timeout)
takes ``engine.simulate``, the single run with the policy flags as Python
bools, instead — the rows are bit for bit the same either way. Results come
back as a flat rows table (one dict per grid point per replication) and,
when ``experiment.out`` is set, are written as a deterministic
``metrics.json`` (byte-identical across reruns of the same spec) plus a
``rows.csv``, with the reference's keys, column order and formatting. The
port compiles nothing, so ``n_compiles`` is ``None`` (``null`` in
``metrics.json``).

``run(..., stream=True)`` returns a :class:`StreamingRun` iterator of
completed row-chunks: the grid is cut into launches of at most
``chunk_scenarios`` scenarios and ``metrics.json``/``rows.csv`` are
rewritten with the rows so far after every chunk, so a crashed or
abandoned stream leaves a valid prefix on disk, and the final files equal
the blocking path's byte for byte. The port's sweep reads the device every
iteration, so ``sweep_async`` has run its chunk when it returns: each chunk
runs inside the ``next()`` that yields it, and no chunk's device work
overlaps another's (that overlap is ROADMAP item 15's). A blocking run is
that stream with one chunk a replication, drained.

Everything runs on ``device`` (``cuda`` unless the caller passes
``"cpu"``; raises when CUDA is asked for and absent). ``devices`` follows
the sweep's contract (None, an int D or ``"all"``): each sweep, a
replication's grid or a streamed chunk, shards its rows over D worker
processes, one per card, and gathers them in grid order, so rows and files
are the unsharded run's byte for byte; a one-point grid runs alone.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
import warnings
from typing import Any, Iterator, Optional, Tuple

from repro_torch.core import engine, sweep
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.experiments.spec import (
    Experiment,
    resolve_platform,
    resolve_workload,
)


@dataclasses.dataclass(frozen=True)
class ExperimentResult:
    """Rows are scheduler-major x timeout [x forecast] [x platform] x
    replication, in grid order (``forecast`` / ``platform`` columns appear
    when the spec has those axes).

    ``n_compiles`` is the reference's compiled-program count; the port
    compiles nothing, so it is ``None``. ``wall_s`` is host wall time for
    all sweeps — reported, never written into metrics.json (determinism).
    """

    experiment: Experiment
    rows: Tuple[dict, ...]
    n_compiles: Optional[int]
    wall_s: float

    @property
    def jobs_per_s(self) -> float:
        sim_jobs = sum(r["n_jobs"] for r in self.rows)
        return sim_jobs / self.wall_s if self.wall_s > 0 else 0.0

    def table(self) -> str:
        """A compact fixed-width text table (CLI output)."""
        cols = ["scheduler", "timeout", "replication", "total_energy_kwh",
                "wasted_energy_kwh", "mean_wait_s", "utilization"]
        if any("platform" in r for r in self.rows):
            cols.insert(2, "platform")
        if any("forecast" in r for r in self.rows):
            cols.insert(2, "forecast")
        lines = [" ".join(f"{c:>18s}" for c in cols)]
        for r in self.rows:
            cells = []
            for c in cols:
                v = r.get(c)
                cells.append(
                    f"{v:>18.3f}" if isinstance(v, float) else f"{str(v):>18s}"
                )
            lines.append(" ".join(cells))
        return "\n".join(lines)


def _metrics_payload(result: ExperimentResult) -> dict:
    return {
        "experiment": dataclasses.asdict(result.experiment),
        "n_compiles": result.n_compiles,
        "rows": list(result.rows),
    }


def _engine_config_with_rl(experiment: Experiment, plat, device):
    """The shared EngineConfig; RL scheduler labels get the checkpointed
    in-graph controller from ``experiment.rl`` attached, loaded onto
    ``device``.

    The controller is the sweep config's, shared by every grid point:
    non-RL rows run with rule 8 gated off, and all RL labels must therefore
    name ONE policy stack.
    """
    from repro_torch.core.policy import RLController, from_label

    cfg = experiment.engine_config()
    rl_stacks = {
        label: pol
        for label in experiment.schedulers
        for _, pol in [from_label(label)]
        if isinstance(pol, RLController)
    }
    if not rl_stacks:
        if experiment.rl is not None:
            raise ValueError(
                "experiment declares an rl checkpoint block but no RL "
                f"scheduler label is in the grid ({list(experiment.schedulers)}); "
                "add an 'RL' / 'RL:groups' / 'RL:dvfs' label or drop the "
                "rl entry"
            )
        return cfg
    if len(set(rl_stacks.values())) > 1:
        raise ValueError(
            "an experiment grid shares ONE in-graph RL controller (static "
            "trace structure); scheduler labels "
            f"{sorted(rl_stacks)} name different RL stacks — split them "
            "into separate experiments"
        )
    if not experiment.rl or "checkpoint" not in experiment.rl:
        raise ValueError(
            f"RL scheduler label(s) {sorted(rl_stacks)} need an "
            'rl: {"checkpoint": <dir>} experiment entry (a policy saved by '
            "training.checkpoint.save_policy)"
        )
    # lazy import: launch.sim imports repro_torch.experiments at module top
    from repro_torch.launch.sim import _resolve_rl_policy

    pol = next(iter(rl_stacks.values()))
    pol, rl = _resolve_rl_policy(pol, {"rl": dict(experiment.rl)}, plat, device)
    return dataclasses.replace(
        cfg,
        policy=pol,
        rl_decision_interval=rl.get("decision_interval"),
    )


def _run_single(plat, wl, scenario, cfg, device):
    """One grid point through the single run (``engine.simulate``).

    The scenario dict is the lowered grid() shape ({scheduler, timeout[,
    forecast_horizon][, platform -> resolved PlatformSpec]}); the label's
    flags are the single run's Python bools, bit for bit the sweep row it
    replaces. Returns the point's SimMetrics.
    """
    from repro_torch.core.metrics import metrics_from_state
    from repro_torch.core.policy import RLController, from_label

    base, pol = from_label(scenario["scheduler"])
    if isinstance(pol, RLController):
        # cfg.policy carries the checkpointed in-graph controller attached
        # by _engine_config_with_rl
        pol = cfg.policy
    plat_i = scenario.get("platform", plat)
    cfg_i = dataclasses.replace(
        cfg,
        base=base,
        policy=pol,
        timeout=scenario["timeout"],
        forecast_horizon=scenario.get("forecast_horizon", cfg.forecast_horizon),
    )
    state = engine.simulate(plat_i, wl, cfg_i, device=device)
    return metrics_from_state(state, plat_i)


def _row(sc: dict, replication: int, m) -> dict:
    """One rows-table entry for grid point ``sc`` (the declarative dict,
    platform still a *name*) — shared by the blocking and streaming paths
    so their rows are identical by construction."""
    row = {
        "scheduler": sc["scheduler"],
        "timeout": sc["timeout"],
    }
    if "forecast" in sc:
        row["forecast"] = sc["forecast"]
    if "platform" in sc:
        row["platform"] = sc["platform"]
    row["replication"] = replication
    row.update(m.row())
    return row


def _warn_capped(rows) -> None:
    capped = [(r["scheduler"], r["timeout"]) for r in rows if r.get("truncated")]
    if capped:
        warnings.warn(
            f"experiment grid point(s) {capped} hit the batch cap before "
            "completing — their rows describe PARTIAL simulations "
            "('truncated' column). Raise max_batches to run to completion.",
            RuntimeWarning,
            stacklevel=3,
        )


def _resolve_run(experiment: Experiment, platform, workload, devices, device):
    """Shared spec resolution for the blocking and streaming paths:
    validate the injection rules and ``devices``, resolve platform + engine
    config, and lower the declarative grid to sweep scenarios. Returns
    ``(plat, cfg, grid, scenarios)`` with ``grid`` keeping the
    platform-axis *names* for the rows table."""
    if workload is not None and experiment.replications > 1:
        raise ValueError(
            "cannot inject a workload into a run with replications > 1: "
            "replications >= 1 regenerate from the spec's workload entry, "
            "which need not match the injected object"
        )
    if experiment.out and (platform is not None or workload is not None):
        raise ValueError(
            "cannot combine injected platform/workload objects with "
            "experiment.out: metrics.json records the spec as the "
            "reproduction recipe, which would not describe what actually "
            "ran; write outputs yourself or put the platform/workload in "
            "the spec"
        )
    # a device count the sweep would refuse raises here, before any chunk
    sweep._resolve_devices(devices, experiment.engine_config(), device)
    plat = platform if platform is not None else resolve_platform(experiment.platform)
    cfg = _engine_config_with_rl(experiment, plat, device)
    # swap platform-axis *names* for resolved PlatformSpecs (sweep
    # scenarios); the declarative grid keeps the names for the rows table
    grid = experiment.grid()
    axis = {name: resolve_platform(spec) for name, spec in experiment.platforms}
    scenarios = []
    for sc in grid:
        sc = dict(sc)
        if "platform" in sc:
            sc["platform"] = axis[sc["platform"]]
        if "forecast" in sc:
            # the declarative forecast axis lowers to the row's
            # EngineConst.forecast_horizon (the sweep's raw field override)
            sc["forecast_horizon"] = sc.pop("forecast")
        scenarios.append(sc)
    return plat, cfg, grid, scenarios


def _metrics(plat, wl, scenarios, cfg, devices, device, single: bool):
    """The SimMetrics of ``scenarios``: the single run of a one-point grid
    (``single``), else one sweep. The engine layers' own truncation
    warnings are muted: the runner emits ONE aggregated warning over its
    rows."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=".*batch cap.*", category=RuntimeWarning
        )
        if single:
            return (_run_single(plat, wl, scenarios[0], cfg, device),)
        return sweep.sweep_async(
            plat, wl, scenarios, cfg, devices=devices, device=device
        ).result().metrics


class StreamingRun:
    """Iterator of completed row-chunks from ``run(..., stream=True)``.

    Each ``next()`` runs the next chunk of the grid and yields its rows (a
    tuple of row dicts, grid order). After exhaustion ``result`` holds the
    final :class:`ExperimentResult` — identical (and, via
    ``experiment.out``, byte-identical on disk) to what the blocking path
    returns.
    """

    def __init__(self, gen: Iterator[Tuple[dict, ...]]):
        self._gen = gen
        self.result: Optional[ExperimentResult] = None

    def __iter__(self) -> "StreamingRun":
        return self

    def __next__(self) -> Tuple[dict, ...]:
        return next(self._gen)


def run(
    experiment: Experiment,
    platform=None,
    workload=None,
    *,
    devices: Optional[Any] = None,
    stream: bool = False,
    chunk_scenarios: Optional[int] = None,
    device: DeviceLike = None,
) -> ExperimentResult:
    """Run the experiment grid on ``device``: one batched sweep per
    replication.

    ``platform`` / ``workload`` optionally inject pre-resolved objects
    (benchmarks construct platforms programmatically); the spec remains the
    declarative record. With both injected and ``replications == 1`` the
    spec's workload/platform entries are never resolved. A workload can only
    be injected into a single-replication run: replications r >= 1 would be
    resolved from the spec, silently mixing two different studies.

    ``devices``: the sweep's contract (None, an int D or ``"all"``; each
    sweep shards its rows over D worker processes). ``stream=True`` returns a
    :class:`StreamingRun` instead of blocking on the whole grid;
    ``chunk_scenarios`` bounds the scenarios per launch (default: the whole
    grid per replication).
    """
    dev = resolve_device(device)
    if not stream and chunk_scenarios is not None:
        raise ValueError(
            "chunk_scenarios only applies to stream=True: the blocking "
            "path runs the whole grid as one launch (its one-compile / "
            "one-dispatch shape is the point)"
        )
    streamed = _run_stream(
        experiment,
        platform,
        workload,
        devices=devices,
        chunk_scenarios=chunk_scenarios,
        device=dev,
    )
    if stream:
        return streamed
    # the port compiles nothing, so a blocking run is the stream of one
    # chunk a replication, drained
    for _ in streamed:
        pass
    return streamed.result


def _run_stream(
    experiment: Experiment,
    platform,
    workload,
    *,
    devices: Optional[Any],
    chunk_scenarios: Optional[int],
    device,
) -> StreamingRun:
    """``run(..., stream=True)``: the same grid as launches of at most
    ``chunk_scenarios`` scenarios, yielded chunk by chunk as each finishes.
    Rows, the aggregated warning, the final ExperimentResult and (when
    ``experiment.out`` is set) the final ``metrics.json``/``rows.csv``
    bytes equal the blocking path's; the outputs are also rewritten with
    the rows so far after every chunk."""
    plat, cfg, grid, scenarios = _resolve_run(
        experiment, platform, workload, devices, device
    )
    chunk = chunk_scenarios if chunk_scenarios is not None else len(scenarios)
    if chunk < 1:
        raise ValueError(f"chunk_scenarios must be >= 1, got {chunk_scenarios!r}")

    holder = StreamingRun(iter(()))

    def gen():
        rows = []
        t0 = time.perf_counter()
        for r in range(experiment.replications):
            # an injected workload implies replications == 1 (guarded in
            # _resolve_run)
            wl = (
                workload
                if workload is not None
                else resolve_workload(experiment.workload, replication=r)
            )
            for lo in range(0, len(scenarios), chunk):
                # a one-point grid takes the single run, as the blocking
                # path does; a one-point chunk of a larger grid is a sweep
                chunk_metrics = _metrics(
                    plat, wl, scenarios[lo:lo + chunk], cfg, devices, device,
                    single=len(scenarios) == 1,
                )
                chunk_rows = tuple(
                    _row(sc, r, m)
                    for sc, m in zip(grid[lo:lo + chunk], chunk_metrics)
                )
                rows.extend(chunk_rows)
                if experiment.out:
                    # incremental rewrite with the rows so far: always a
                    # valid prefix; the last equals the blocking path's
                    write_outputs(
                        ExperimentResult(
                            experiment=experiment,
                            rows=tuple(rows),
                            n_compiles=None,
                            wall_s=time.perf_counter() - t0,
                        ),
                        experiment.out,
                    )
                yield chunk_rows

        wall = time.perf_counter() - t0
        _warn_capped(rows)
        result = ExperimentResult(
            experiment=experiment,
            rows=tuple(rows),
            n_compiles=None,
            wall_s=wall,
        )
        if experiment.out:
            write_outputs(result, experiment.out)
        holder.result = result

    holder._gen = gen()
    return holder


def write_outputs(result: ExperimentResult, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(_metrics_payload(result), f, indent=2, sort_keys=True)
        f.write("\n")
    rows = result.rows
    lead = ["scheduler", "timeout", "forecast", "platform", "replication"]
    cols = sorted({k for r in rows for k in r}, key=lambda c: (
        lead.index(c) if c in lead else len(lead),
        c,
    ))
    with open(os.path.join(out_dir, "rows.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)


def run_file(path: str, device: DeviceLike = None) -> ExperimentResult:
    """CLI entry: load a spec file and run it (``launch/sim.py --experiment``)."""
    return run(Experiment.load(path), device=device)
