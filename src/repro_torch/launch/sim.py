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
them. RL labels (``"EASY RL"``, ``"EASY RL:groups"``, ``"EASY RL:dvfs"``)
need an ``rl: {checkpoint: <dir>, decision_interval: s}`` block: the policy
saved by ``training.checkpoint.save_policy`` (of either package) drives the
run greedily through the engine's in-graph controller hook, features ->
logits -> argmax -> action translator, all on the device.
``--experiment spec.json`` runs a declarative grid spec through
``repro_torch.experiments.run_file`` (the batched sweep), with the
reference's clash check against the single-run flags.
"""
from __future__ import annotations

import argparse
import copy
import csv
import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Optional

import torch

from repro_torch.core import engine
from repro_torch.core.gantt import intervals_from_log, render_png, write_csv
from repro_torch.core.metrics import metrics_from_state, np_state
from repro_torch.core.policy import RLController, from_label, scheduler_labels
from repro_torch.core.rl.actions import (
    ACTION_TRANSLATORS,
    DVFS_ACTIONS,
    action_space_size,
)
from repro_torch.core.rl.features import extract, feature_size
from repro_torch.core.types import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.experiments import (
    check_unknown_keys,
    resolve_platform,
    resolve_workload,
)
from repro_torch.experiments.spec import _KNOWN_RL_KEYS
from repro_torch.training.checkpoint import load_policy

# single-run config keys (the reference's set)
_KNOWN_KEYS = {
    "workload", "platform", "scheduler", "timeout", "terminate_overrun",
    "node_order", "allocation", "rl", "gantt", "out", "grouped_tables",
    "merge_bursts", "forecast_horizon", "forecast_alpha",
}


def _validate_keys(config: Dict[str, Any]) -> None:
    """Reject unknown config keys loudly instead of silently ignoring typos."""
    check_unknown_keys(config, _KNOWN_KEYS, "config")
    rl = config.get("rl")
    if isinstance(rl, dict):
        check_unknown_keys(rl, _KNOWN_RL_KEYS, "rl config")


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


class _CheckpointController:
    """Greedy in-graph controller: features -> argmax logits -> commands,
    on the state's device (no host read). The same controller steps a single
    state or a sweep's ``[E]`` rows (features of every row, one batched
    forward, an argmax per row, the translator over rows), as the batched
    RL env does; its ``rows`` attribute marks it for the sweep.

    A class at module level, so that a sharded sweep can send it to its
    worker processes: it pickles with the policy's parameters on the CPU,
    and ``to(device)`` gives a copy whose parameters are on ``device``."""

    def __init__(self, params, meta):
        self.params, self.meta = params, meta

    @property
    def rows(self) -> "_CheckpointController":
        return self

    def __call__(self, s, const):
        meta = self.meta
        with torch.no_grad():
            logits, _ = self.params(
                extract(meta["feature"], s, const, meta.get("feature_window", 8)))
        return ACTION_TRANSLATORS[meta["action"]](
            s, const, torch.argmax(logits, dim=-1), meta["n_levels"])

    def to(self, device) -> "_CheckpointController":
        return _CheckpointController(copy.deepcopy(self.params).to(device), self.meta)

    def __getstate__(self):
        return {"params": self.to("cpu").params, "meta": self.meta}


def _resolve_rl_policy(pol, config, plat, device):
    """Attach the checkpointed greedy controller to an RLController policy
    (the reference's checks and messages)."""
    rl = config.get("rl") or {}
    if "checkpoint" not in rl:
        raise ValueError(
            "RL schedulers need an rl: {checkpoint: <dir>} config block "
            "(a policy saved by training.checkpoint.save_policy)"
        )
    params, meta = load_policy(rl["checkpoint"], device=device)
    expected_obs = feature_size(
        meta["feature"], meta.get("feature_window", 8), plat.n_groups()
    )
    if meta["obs_size"] != expected_obs:
        raise ValueError(
            f"RL checkpoint obs_size={meta['obs_size']} does not fit this "
            f"platform ({plat.n_groups()} node groups -> obs_size "
            f"{expected_obs} for feature {meta['feature']!r}); retrain or "
            "pick a matching platform"
        )
    if bool(meta.get("grouped", False)) != pol.grouped:
        raise ValueError(
            f"RL checkpoint was trained with grouped={meta.get('grouped')} "
            f"actions but scheduler label requests grouped={pol.grouped}; "
            "use the matching 'RL' / 'RL:groups' label"
        )
    if bool(meta.get("dvfs", False)) != pol.dvfs:
        raise ValueError(
            f"RL checkpoint was trained with dvfs={meta.get('dvfs', False)} "
            f"but scheduler label requests dvfs={pol.dvfs}; use the "
            "matching 'RL' / 'RL:dvfs' label"
        )
    if pol.dvfs and meta["action"] in DVFS_ACTIONS and (
        meta["n_levels"] != plat.n_dvfs_modes()
    ):
        raise ValueError(
            f"RL checkpoint commands {meta['n_levels']} DVFS modes but "
            f"this platform's mode-table width is {plat.n_dvfs_modes()}"
            "; mode commands would be mis-decoded — retrain or pick a "
            "matching platform"
        )
    if pol.grouped:
        ckpt_groups = int(meta.get("n_groups", 1))
        expected_actions = action_space_size(
            meta["action"], meta["n_levels"], plat.n_groups()
        )
        if ckpt_groups != plat.n_groups() or meta["n_actions"] != expected_actions:
            raise ValueError(
                f"RL checkpoint was trained for {ckpt_groups} node groups "
                f"({meta['n_actions']} actions) but this platform has "
                f"{plat.n_groups()} groups ({expected_actions} actions for "
                f"action {meta['action']!r}); group-targeted commands would "
                "be mis-decoded — retrain or pick a matching platform"
            )
    controller = _CheckpointController(params, meta)
    return dataclasses.replace(pol, controller=controller), rl


def engine_config(config: Dict[str, Any], device=None):
    """(workload, platform, scheduler label, EngineConfig) of a single-run
    config, an RL label's checkpointed controller loaded onto ``device``."""
    _validate_keys(config)
    dev = resolve_device(device)
    wl = resolve_workload(config["workload"])
    plat = resolve_platform(config.get("platform", wl.nb_res))
    sched = config.get("scheduler", "EASY PSUS")
    base, pol = from_label(sched)
    rl_interval = None
    if isinstance(pol, RLController):
        pol, rl = _resolve_rl_policy(pol, config, plat, dev)
        rl_interval = rl.get("decision_interval")
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
        rl_decision_interval=rl_interval,
        grouped_tables=bool(config.get("grouped_tables", False)),
        merge_bursts=bool(config.get("merge_bursts", False)),
        forecast_horizon=config.get("forecast_horizon"),
        forecast_alpha=float(config.get("forecast_alpha", 0.25)),
    )
    engine.check_supported(ecfg)
    return wl, plat, sched, ecfg


def run(config: Dict[str, Any], device: Optional[str] = None) -> Dict[str, Any]:
    """One simulation from a config dict; writes the outputs and returns the
    metrics row (the reference's ``run``)."""
    dev = resolve_device(device)
    wl, plat, sched, ecfg = engine_config(config, dev)
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
        help="run a declarative repro_torch.experiments grid spec "
             "(the scheduler x timeout grid as one batched sweep)",
    )
    ap.add_argument("--workload", default=None)
    ap.add_argument("--platform", default=None)
    ap.add_argument(
        "--scheduler",
        default="EASY PSUS",
        metavar="LABEL",
        help="a policy.from_label scheduler label: "
             f"{', '.join(scheduler_labels(include_rl=True, include_dvfs=True))}"
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
        # the spec is the whole study: reject single-run flags rather than
        # silently ignoring them (--device says where it runs, not what)
        clashing = [
            f"--{name.replace('_', '-')}"
            for name in (
                "config", "workload", "platform", "scheduler", "timeout",
                "terminate_overrun", "out",
            )
            if getattr(args, name) != ap.get_default(name)
        ]
        if clashing:
            ap.error(
                f"--experiment runs a self-contained spec; {', '.join(clashing)} "
                "would be ignored — set the equivalent field in the spec file"
            )
        from repro_torch.experiments import run_file

        result = run_file(args.experiment, device=args.device)
        print(result.table())
        print(
            f"# grid: {len(result.rows)} rows, "
            f"{result.n_compiles if result.n_compiles is not None else '?'} "
            f"compiled program(s), {result.wall_s:.2f}s "
            f"({result.jobs_per_s:.0f} simulated jobs/s)"
        )
        return result

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
