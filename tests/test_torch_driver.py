"""The PyTorch port's single-run driver against the reference's: the golden
heterogeneous config of ``tests/test_sim_driver.py`` gives the same
``metrics.json`` keys and values and the same ``jobs.csv``; a rerun is
byte-identical; the gantt path writes the same ``gantt.csv``; a grouped
Curie-class SWF replay writes a byte-identical ``metrics.json``; and an
unknown config key, or a single-run flag beside ``--experiment``, fails
loudly.
"""
import json
import os

import pytest

from repro.launch.sim import main as main_ref
from repro.launch.sim import run as run_ref
from repro_torch.launch import sim as tsim
from repro_torch.workloads.platform import curie_platform, dvfs_platform_example
from repro_torch.workloads.traces import synthesize_curie_swf

HETERO_PLATFORM_JSON = {
    "node_groups": [
        {
            "name": "fast",
            "count": 6,
            "compute_speed": 2.0,
            "states": {
                "sleep": {"power": 12.0},
                "idle": {"power": 250.0},
                "active": {"power": 300.0},
                "switching_on": {"power": 300.0, "transition_time": 600},
                "switching_off": {"power": 12.0, "transition_time": 900},
            },
        },
        {
            "name": "eco",
            "count": 10,
            "compute_speed": 0.5,
            "states": {
                "sleep": {"power": 4.0},
                "idle": {"power": 80.0},
                "active": {"power": 100.0},
                "switching_on": {"power": 100.0, "transition_time": 120},
                "switching_off": {"power": 4.0, "transition_time": 180},
            },
        },
    ]
}


def _config(tmp_path, **kw):
    plat = tmp_path / "platform.json"
    plat.write_text(json.dumps(HETERO_PLATFORM_JSON))
    return {
        "workload": "preset:fig3_small",
        "platform": str(plat),
        "scheduler": "EASY PSAS",
        "timeout": 300,
        "terminate_overrun": True,
        **kw,
    }


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_golden_run_matches_reference_and_reruns_byte_identical(tmp_path):
    cfg = _config(tmp_path, gantt=False)
    ref = run_ref({**cfg, "out": str(tmp_path / "ref")})
    port = tsim.run({**cfg, "out": str(tmp_path / "port")}, device="cpu")
    assert set(port) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert port[k] == pytest.approx(v, rel=1e-5), k
        else:
            assert port[k] == v, k
    assert _read(tmp_path / "port" / "jobs.csv") == _read(
        tmp_path / "ref" / "jobs.csv"
    )
    with open(tmp_path / "port" / "metrics.json") as f:
        assert json.load(f) == port

    again = tsim.run({**cfg, "out": str(tmp_path / "again")}, device="cpu")
    assert again == port
    assert _read(tmp_path / "again" / "metrics.json") == _read(
        tmp_path / "port" / "metrics.json"
    )


def test_gantt_run_writes_the_reference_outputs(tmp_path):
    cfg = _config(
        tmp_path, scheduler="FCFS PSAS+IPM",
        workload={"preset": "fig3_small", "n_jobs": 60},
    )
    run_ref({**cfg, "out": str(tmp_path / "ref")})
    tsim.run({**cfg, "out": str(tmp_path / "port")}, device="cpu")
    for name in ("jobs.csv", "gantt.csv"):
        assert _read(tmp_path / "port" / name) == _read(
            tmp_path / "ref" / name
        ), name
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref")
    )


def test_cli_runs_on_the_cpu_when_asked(tmp_path, capsys):
    out = tmp_path / "cli"
    result = tsim.main([
        "--workload", "preset:fig3_small", "--platform", "16",
        "--scheduler", "FCFS PSUS", "--timeout", "900",
        "--out", str(out), "--device", "cpu",
    ])
    assert json.loads(capsys.readouterr().out) == result
    for name in ("metrics.json", "jobs.csv", "gantt.csv"):
        assert (out / name).exists(), name


def test_grouped_swf_replay_metrics_are_byte_identical(tmp_path):
    """The grouped Curie-class replay (3-group Curie platform, SWF trace,
    grouped tables, burst merging) through both packages' command lines:
    ``metrics.json`` byte for byte. The grouped ledger is elementwise f32
    (no reduction whose order could differ), so the energies agree
    exactly."""
    swf = synthesize_curie_swf(str(tmp_path / "curie.swf"), n_jobs=300)
    curie_platform(40).save(str(tmp_path / "curie.json"))
    cfg = {
        "workload": {"swf": swf, "nb_nodes": 40, "oversize": "clamp",
                     "max_jobs": 80},
        "platform": str(tmp_path / "curie.json"),
        "scheduler": "EASY PSAS", "timeout": 600, "grouped_tables": True,
        "merge_bursts": True, "gantt": False,
    }
    outs = {}
    for name, main, extra in (("ref", main_ref, []),
                              ("port", tsim.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({**cfg, "out": str(tmp_path / name)}))
        main(["--config", str(path), *extra])
        outs[name] = _read(tmp_path / name / "metrics.json")
    assert outs["port"] == outs["ref"]
    assert json.loads(outs["port"])["n_jobs"] == 80


@pytest.mark.parametrize(
    "extra",
    [
        {"scheduler": "EASY PSUS+DVFS", "grouped_tables": True, "gantt": False},
        {"scheduler": "EASY PSUS+Forecast", "forecast_horizon": 1800,
         "forecast_alpha": 0.5},
        {"scheduler": "FCFS DVFS+Forecast", "forecast_horizon": 600,
         "node_order": "id", "gantt": False},
    ],
    ids=["dvfs-grouped", "forecast-gantt", "dvfs-forecast"],
)
def test_dvfs_and_forecast_labels_match_the_reference(tmp_path, extra):
    """Rules 9-10 through both packages' ``run`` on the reference's DVFS
    platform (as a JSON file), the forecast operands parsed from the
    config: the same metrics (floats to rel 1e-5, the rest equal), the same
    job log, and the gantt log when it is drawn."""
    dvfs_platform_example(16).save(str(tmp_path / "dvfs.json"))
    cfg = {**_config(tmp_path), "platform": str(tmp_path / "dvfs.json"), **extra}
    ref = run_ref({**cfg, "out": str(tmp_path / "ref")})
    port = tsim.run({**cfg, "out": str(tmp_path / "port")}, device="cpu")
    assert set(port) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert port[k] == pytest.approx(v, rel=1e-5), k
        else:
            assert port[k] == v, k
    # the mode columns appear exactly when DVFS ran
    assert any(k.startswith("mode_s.") for k in port) == ("DVFS" in cfg["scheduler"])
    names = ["jobs.csv"] + (["gantt.csv"] if cfg.get("gantt", True) else [])
    for name in names:
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "ref" / name), name


def test_unknown_keys_and_experiments_are_refused(tmp_path, capsys):
    with pytest.raises(ValueError, match="did you mean 'timeout'"):
        tsim.run({"workload": "preset:fig3_small", "timout": 3}, device="cpu")
    # --experiment runs a self-contained spec: a single-run flag beside it
    # is refused, as the reference refuses it
    with pytest.raises(SystemExit):
        tsim.main(["--experiment", str(tmp_path / "exp.json"), "--timeout", "5"])
    assert "--timeout would be ignored" in capsys.readouterr().err
