"""Declarative experiment layer over the batched sweep — the counterpart of
the reference's ``repro.experiments``.

An :class:`Experiment` is a frozen, JSON-round-trippable spec of a full
study — workload, platform, a scheduler x timeout grid, replications, output
directory — and :func:`run` evaluates the whole grid as one batched sweep
per replication (``core/sweep.py``), on the CUDA device unless the caller
passes ``device="cpu"``. This is the paper's "JSON-configurable,
reproducible experiments" layer (§2.3.2/2.3.3), scaled to grids: the Figs.
4/5 six-scheduler comparison is one loop over its rows, not six runs.

    from repro_torch import experiments
    exp = experiments.Experiment(
        name="fig45",
        workload={"preset": "nasa_ipsc", "n_jobs": 400},
        platform=128,
        schedulers=("EASY PSUS", "EASY PSAS", "EASY PSAS+IPM"),
        timeouts=(300, 900, 1800),
    )
    result = experiments.run(exp)     # result.rows: one dict a grid point
    exp.save("exp.json")              # and back: Experiment.load("exp.json")

CLI: ``python -m repro_torch.launch.sim --experiment exp.json``.
"""
from repro_torch.experiments.spec import (
    Experiment,
    check_unknown_keys,
    check_workload_keys,
    resolve_platform,
    resolve_workload,
)
from repro_torch.experiments.runner import (
    ExperimentResult,
    StreamingRun,
    run,
    run_file,
)

__all__ = [
    "Experiment",
    "ExperimentResult",
    "StreamingRun",
    "check_unknown_keys",
    "check_workload_keys",
    "resolve_platform",
    "resolve_workload",
    "run",
    "run_file",
]
