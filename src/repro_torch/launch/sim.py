"""Simulator driver on PyTorch — the counterpart of the reference's
``launch/sim.py`` single run (the paper's ``runner.py`` +
``simulator_config.yaml``, §2.3.2/2.3.3).

    PYTHONPATH=src python -m repro_torch.launch.sim --config cfg.json
    PYTHONPATH=src python -m repro_torch.launch.sim --workload preset:fig3_small \\
        --platform 16 --scheduler "EASY PSUS" --timeout 900 --out out/run1

Runs on the CUDA device unless ``--device cpu`` (or ``run(..., device=
"cpu")``) asks for the CPU. Writes ``metrics.json``, ``jobs.csv``,
``gantt.csv`` and ``gantt.png`` (the PNG when matplotlib is installed) into
``out``, exactly as the reference does.

Config keys: the reference's (workload, platform, scheduler, timeout,
terminate_overrun, node_order, allocation, gantt, out, grouped_tables,
merge_bursts, forecast_horizon, forecast_alpha, rl), with its defaults.
``workload`` also takes ``"swf:<path>"`` and ``{"swf": <path>, ...}`` trace
replays. For example, the first 1000 jobs of a Curie-class trace on a
3-group Curie platform written as a ``node_groups`` JSON::

    {"workload": {"swf": "curie.swf", "nb_nodes": 11200,
                  "oversize": "clamp", "max_jobs": 1000},
     "platform": "curie_platform.json", "scheduler": "EASY PSUS",
     "timeout": 1800, "grouped_tables": true, "gantt": false}

DVFS and Forecast labels run, alone and composed (``"EASY DVFS"``,
``"EASY PSUS+DVFS"``, ``"EASY PSUS+Forecast"``, ...), with the rule 10
operands ``forecast_horizon`` / ``forecast_alpha`` as the reference parses
them. Configurations the port does not run yet — RL labels and the ``rl``
block (they need a checkpointed network), ``--experiment`` grids, the
``profiles`` workload — raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import warnings
from typing import Any, Dict, Optional

from repro_torch.core import engine
from repro_torch.core.gantt import intervals_from_log, render_png, write_csv
from repro_torch.core.metrics import metrics_from_state, np_state
from repro_torch.core.policy import RLController, from_label, scheduler_labels
from repro_torch.core.types import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.experiments import (
    check_unknown_keys,
    resolve_platform,
    resolve_workload,
)

# single-run config keys (the reference's set)
_KNOWN_KEYS = {
    "workload", "platform", "scheduler", "timeout", "terminate_overrun",
    "node_order", "allocation", "rl", "gantt", "out", "grouped_tables",
    "merge_bursts", "forecast_horizon", "forecast_alpha",
}


def _load_mini_yaml(path: str) -> Dict[str, Any]:
    """JSON, or a flat ``key: value`` YAML subset (no PyYAML needed)."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    out: Dict[str, Any] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        k, v = line.split(":", 1)
        v = v.strip()
        if v.lower() in ("null", "none", ""):
            out[k.strip()] = None
        elif v.lower() in ("true", "false"):
            out[k.strip()] = v.lower() == "true"
        else:
            try:
                out[k.strip()] = int(v)
            except ValueError:
                try:
                    out[k.strip()] = float(v)
                except ValueError:
                    out[k.strip()] = v.strip("'\"")
    return out


def run(config: Dict[str, Any], device: Optional[str] = None) -> Dict[str, Any]:
    """One simulation from a config dict; writes the outputs and returns the
    metrics row (the reference's ``run``)."""
    check_unknown_keys(config, _KNOWN_KEYS, "config")
    dev = resolve_device(device)
    sched = config.get("scheduler", "EASY PSUS")
    base, pol = from_label(sched)
    if isinstance(pol, RLController) or config.get("rl") is not None:
        raise NotImplementedError(
            f"{sched!r}: RL schedulers and the 'rl' config block drive the "
            "engine with a checkpointed network, which is not ported to the "
            "PyTorch engine yet (ROADMAP Queue 1 item 10)"
        )
    wl = resolve_workload(config["workload"])
    plat = resolve_platform(config.get("platform", wl.nb_res))
    # heterogeneous platforms default to cost-aware node selection
    node_order = config.get(
        "node_order", "cheap" if plat.is_heterogeneous else "id"
    )
    ecfg = EngineConfig(
        base=base,
        policy=pol,
        timeout=config.get("timeout"),
        terminate_overrun=bool(config.get("terminate_overrun", False)),
        record_gantt=bool(config.get("gantt", True)),
        node_order=node_order,
        allocation=config.get("allocation", "any"),
        grouped_tables=bool(config.get("grouped_tables", False)),
        merge_bursts=bool(config.get("merge_bursts", False)),
        forecast_horizon=config.get("forecast_horizon"),
        forecast_alpha=float(config.get("forecast_alpha", 0.25)),
    )
    engine.check_supported(ecfg)
    out_dir = config.get("out", "out/sim")
    os.makedirs(out_dir, exist_ok=True)

    cap = engine.default_batch_cap(len(wl))
    if ecfg.record_gantt:
        s0 = engine.init_state(plat, wl, ecfg, device=dev)
        const = engine.make_const(plat, ecfg, device=dev)
        s, log = engine.run_sim_gantt(s0, const, ecfg, max_batches=cap)
        intervals = intervals_from_log(log)
        write_csv(intervals, os.path.join(out_dir, "gantt.csv"))
        d = np_state(s)
        render_png(
            intervals,
            os.path.join(out_dir, "gantt.png"),
            terminated_jobs=[int(j) for j in d["job_terminated"].nonzero()[0]],
            title=f"{sched} timeout={ecfg.timeout}",
        )
    else:
        s = engine.simulate(plat, wl, ecfg, device=dev)

    m = metrics_from_state(s, plat)
    if m.truncated and ecfg.record_gantt:
        # engine.simulate already warns for the non-gantt path; keep the
        # gantt path just as loud — a capped run must not read as finished
        warnings.warn(
            f"run {sched!r} hit the batch cap ({cap}) before completing — "
            "metrics.json describes a PARTIAL simulation ('truncated': "
            "true). Raise max_batches to run to completion.",
            RuntimeWarning,
            stacklevel=2,
        )

    # CSV job log (paper §2.3.3: "CSV outputs including job execution logs")
    d = np_state(s)
    with open(os.path.join(out_dir, "jobs.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["job", "res", "subtime", "start", "finish", "wait", "terminated"])
        arrs = wl.arrays()
        for i in range(len(wl)):
            if not d["job_exists"][i]:
                continue
            w.writerow(
                [
                    int(arrs["job_id"][i]), int(d["job_res"][i]),
                    int(d["job_subtime"][i]), int(d["job_start"][i]),
                    int(d["job_finish"][i]),
                    int(d["job_start"][i] - d["job_subtime"][i]),
                    bool(d["job_terminated"][i]),
                ]
            )
    result = {"scheduler": sched, "timeout": ecfg.timeout, **m.row()}
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument(
        "--experiment", default=None, metavar="SPEC.json",
        help="experiment grids are not ported yet (raises)",
    )
    ap.add_argument("--workload", default=None)
    ap.add_argument("--platform", default=None)
    ap.add_argument(
        "--scheduler",
        default="EASY PSUS",
        metavar="LABEL",
        help="a policy.from_label scheduler label: "
             f"{', '.join(scheduler_labels(include_dvfs=True))}"
             ", or '<PSM>+DVFS' / '<PSM>+Forecast' composing rule 9 / "
             "rule 10 onto any stack (e.g. 'EASY PSAS+IPM+DVFS', "
             "'EASY PSUS+Forecast')",
    )
    ap.add_argument("--timeout", type=int, default=None)
    ap.add_argument("--terminate-overrun", action="store_true")
    ap.add_argument("--out", default="out/sim")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: cuda; 'cpu' runs on the CPU)",
    )
    args = ap.parse_args(argv)
    try:
        from_label(args.scheduler)
    except KeyError as e:
        ap.error(str(e.args[0]) if e.args else str(e))
    if args.experiment:
        raise NotImplementedError(
            "--experiment grids run through the experiment runner, which is "
            "not ported to the PyTorch engine yet (ROADMAP Queue 1 items 8-9; "
            "the batched sweep itself is repro_torch.core.sweep)"
        )
    if args.config:
        config = _load_mini_yaml(args.config)
    else:
        config = {
            "workload": args.workload or "preset:fig3_small",
            "scheduler": args.scheduler,
            "timeout": args.timeout,
            "terminate_overrun": args.terminate_overrun,
            "out": args.out,
        }
        if args.platform:
            config["platform"] = (
                int(args.platform) if args.platform.isdigit() else args.platform
            )
    result = run(config, device=args.device)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
