"""The PyTorch port's experiment layer (``repro_torch.experiments``) on the
CPU, against the JAX reference's ``repro.experiments`` on the same specs.

- ``Experiment``'s JSON round-trip, and every rejection of the spec and of
  ``run`` with the reference's message;
- the paper's six timeout schedulers x 2 timeouts on ``fig3_small`` (50
  jobs, 16 nodes) through both runners: every row has the reference's keys
  in its order, every non-energy column equal and every ``*_kwh`` column to
  rel 1e-5 (the reference's SEMANTICS §Numerics); the ``experiment`` block
  of ``metrics.json`` is the reference's, ``n_compiles`` is ``null`` and
  ``rows.csv``'s header is the reference's;
- a rerun and every streamed run (chunks of 1, 5 and the whole grid) write
  the blocking run's bytes, and ``metrics.json`` parses with the rows so
  far after every chunk;
- replications advance the seed; a single-point grid equals its sweep row
  bit for bit; a forecast-axis grid and an ``RL:groups`` grid with a
  checkpoint saved by the JAX package give the JAX runner's rows;
- ``--experiment`` writes ``run_file``'s files; the new modules import
  neither jax nor ``repro``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro import experiments as jexp
from repro_torch import experiments as texp
from repro_torch.core.rl.actions import action_space_size
from repro_torch.core.rl.features import feature_size
from repro_torch.launch import sim as tsim
from repro_torch.workloads.platform import mixed_platform_example

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_rl_checkpoint import _save_ckpt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SIX = tuple(f"{b} {p}" for p in ("PSUS", "PSAS", "PSAS+IPM") for b in ("FCFS", "EASY"))
FIG3 = dict(name="fig3", workload={"preset": "fig3_small", "n_jobs": 50},
            platform=16, schedulers=SIX, timeouts=(120, 900), terminate_overrun=True)


def _message(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return type(e).__name__, str(e)
    raise AssertionError("expected an exception")


def _same_rows(port_rows, ref_rows):
    assert len(port_rows) == len(ref_rows)
    for p, r in zip(port_rows, ref_rows):
        assert list(p) == list(r)
        for k, v in r.items():
            if k.endswith("_kwh"):
                assert p[k] == pytest.approx(v, rel=1e-5), (r["scheduler"], k)
            else:
                assert p[k] == v, (r["scheduler"], r["timeout"], k)


@pytest.fixture(scope="module")
def fig3(tmp_path_factory):
    """Both runners on FIG3, written to the same ``out`` one after the
    other: (reference result, its files, port result, its files)."""
    out = str(tmp_path_factory.mktemp("fig3") / "out")
    spec = dict(FIG3, out=out)

    def files():
        return {n: open(os.path.join(out, n), "rb").read()
                for n in ("metrics.json", "rows.csv")}

    ref = jexp.run(jexp.Experiment(**spec))
    ref_files = files()
    port = texp.run(texp.Experiment(**spec), device=CPU)
    return ref, ref_files, port, files()


# --------------------------------------------------------------------------
# the spec
# --------------------------------------------------------------------------

def test_experiment_json_roundtrip_is_the_reference_json():
    kw = dict(name="rt", workload={"preset": "fig3_small", "n_jobs": 40}, platform=16,
              schedulers=SIX, timeouts=(60, 300, None), forecasts=(None, 900),
              node_order="cheap", terminate_overrun=True, replications=2,
              platforms={"a": 16, "b": {"nb_nodes": 16, "power_idle": 120.0}},
              out="out/rt")
    exp = texp.Experiment(**kw)
    again = texp.Experiment.from_json(exp.to_json())
    assert again == exp and again.schedulers == SIX
    assert exp.to_json() == jexp.Experiment(**kw).to_json()
    assert again.grid() == jexp.Experiment(**kw).grid()
    assert again.grid()[0] == {"scheduler": SIX[0], "timeout": 60, "platform": "a"}


SPEC_ERRORS = {
    "unknown key": lambda m: m.Experiment.from_json(json.dumps(
        {"name": "x", "workload": "preset:fig3_small", "platform": 16,
         "scheduler": ["EASY PSUS"]})),
    "not an object": lambda m: m.Experiment.from_json("[1, 2]"),
    "unknown label": lambda m: m.Experiment(
        name="x", workload="preset:fig3_small", platform=16, schedulers=("EASY TURBO",)),
    "no scheduler": lambda m: m.Experiment(
        name="x", workload="preset:fig3_small", platform=16, schedulers=()),
    "no forecast": lambda m: m.Experiment(
        name="x", workload="preset:fig3_small", platform=16, forecasts=()),
    "bad forecast": lambda m: m.Experiment(
        name="x", workload="preset:fig3_small", platform=16, forecasts=(-5,)),
    "replications": lambda m: m.Experiment(
        name="x", workload="preset:fig3_small", platform=16, replications=0),
    "workload key": lambda m: m.Experiment(
        name="x", platform=16, workload={"preset": "fig3_small", "n_job": 40}),
    "swf key": lambda m: m.Experiment(
        name="x", platform=16, workload={"swf": "x.swf", "max_job": 4}),
    "rl key": lambda m: m.Experiment(
        name="x", workload="preset:fig3_small", platform=16, rl={"checkpont": "x"}),
    "platform pair": lambda m: m.Experiment(
        name="x", workload="preset:fig3_small", platform=16, platforms=("a",)),
    "platform names": lambda m: m.Experiment(
        name="x", workload="preset:fig3_small", platform=16,
        platforms=(("a", 16), ("a", 16))),
    "profiles replication": lambda m: m.resolve_workload("profiles", replication=1),
}


@pytest.mark.parametrize("case", sorted(SPEC_ERRORS))
def test_spec_rejections_are_the_reference_messages(case):
    fn = SPEC_ERRORS[case]
    assert _message(lambda: fn(texp)) == _message(lambda: fn(jexp))


def _small(m, **kw):
    return m.Experiment(**{**dict(name="bad", workload={"preset": "fig3_small", "n_jobs": 10},
                                  platform=8), **kw})


RUN_ERRORS = {
    "inject with out": lambda m, run, tmp: run(
        _small(m, out=str(tmp)), workload=m.resolve_workload(
            {"preset": "fig3_small", "n_jobs": 10})),
    "inject with replications": lambda m, run, tmp: run(
        _small(m, replications=2), workload=m.resolve_workload(
            {"preset": "fig3_small", "n_jobs": 10})),
    "chunk without stream": lambda m, run, tmp: run(_small(m), chunk_scenarios=2),
    "chunk below one": lambda m, run, tmp: run(_small(m), stream=True, chunk_scenarios=0),
    "rl without label": lambda m, run, tmp: run(_small(m, rl={"checkpoint": str(tmp)})),
    "label without rl": lambda m, run, tmp: run(_small(m, schedulers=("EASY RL",))),
    "two rl stacks": lambda m, run, tmp: run(
        _small(m, schedulers=("EASY RL", "EASY RL:groups"), rl={"checkpoint": str(tmp)})),
}


@pytest.mark.parametrize("case", sorted(RUN_ERRORS))
def test_run_rejections_are_the_reference_messages(case, tmp_path):
    fn = RUN_ERRORS[case]
    port = _message(lambda: fn(texp, lambda *a, **k: texp.run(*a, device=CPU, **k),
                               tmp_path))
    assert port == _message(lambda: fn(jexp, jexp.run, tmp_path))


def test_run_needs_cuda_unless_asked_for_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for its absence")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texp.run(_small(texp))


# --------------------------------------------------------------------------
# the fig3 grid against the reference runner
# --------------------------------------------------------------------------

def test_fig3_rows_are_the_reference_rows(fig3):
    ref, _, port, _ = fig3
    assert len(port.rows) == len(SIX) * 2
    _same_rows(port.rows, ref.rows)
    assert port.n_compiles is None and port.jobs_per_s > 0
    assert port.table().splitlines()[0] == ref.table().splitlines()[0]


def test_fig3_files_keep_the_reference_layout(fig3):
    _, ref_files, _, files = fig3
    ref_m, m = json.loads(ref_files["metrics.json"]), json.loads(files["metrics.json"])
    assert m["experiment"] == ref_m["experiment"]
    assert m["n_compiles"] is None and ref_m["n_compiles"] == 1
    assert sorted(m) == sorted(ref_m)
    _same_rows(m["rows"], ref_m["rows"])
    assert files["rows.csv"].splitlines()[0] == ref_files["rows.csv"].splitlines()[0]


def test_golden_rerun_is_byte_identical(fig3):
    *_, port, files = fig3
    again = texp.run(port.experiment, device=CPU)
    assert again.rows == port.rows
    for name, want in files.items():
        assert open(os.path.join(port.experiment.out, name), "rb").read() == want, name


@pytest.mark.parametrize("chunk", [1, 5, None])
def test_streams_write_prefixes_then_the_blocking_bytes(fig3, chunk):
    *_, port, files = fig3
    out = port.experiment.out
    sr = texp.run(port.experiment, stream=True, chunk_scenarios=chunk, device=CPU)
    seen, sizes = [], []
    for rows in sr:
        seen.extend(rows)
        sizes.append(len(rows))
        with open(os.path.join(out, "metrics.json")) as f:
            assert json.load(f)["rows"] == seen  # a valid prefix on disk
    n = len(port.rows)
    k = chunk or n
    assert sizes == [min(k, n - lo) for lo in range(0, n, k)]
    assert seen == list(port.rows) == list(sr.result.rows)
    for name, data in files.items():
        assert open(os.path.join(out, name), "rb").read() == data, name


def test_replications_advance_the_seed():
    exp = texp.Experiment(name="reps", workload={"preset": "fig3_small", "n_jobs": 30},
                          platform=16, schedulers=("EASY PSUS", "FCFS PSAS"),
                          timeouts=(300,), replications=2)
    rows = texp.run(exp, device=CPU).rows
    assert [r["replication"] for r in rows] == [0, 0, 1, 1]
    assert rows[0]["total_energy_kwh"] != rows[2]["total_energy_kwh"]
    from repro_torch.workloads.generator import PRESETS

    shifted = dataclasses.replace(
        exp, replications=1,
        workload={"preset": "fig3_small", "n_jobs": 30, "seed": PRESETS["fig3_small"].seed + 1})
    again = texp.run(shifted, device=CPU).rows
    assert [dict(r, replication=1) for r in again] == list(rows[2:])


def test_single_point_grid_is_its_sweep_row_bit_for_bit(fig3):
    *_, port, _ = fig3
    for i in (3, 10):
        want = port.rows[i]
        one = dataclasses.replace(port.experiment, schedulers=(want["scheduler"],),
                                  timeouts=(want["timeout"],), out=None)
        assert texp.run(one, device=CPU).rows == (want,)


# --------------------------------------------------------------------------
# forecast and RL:groups grids against the reference runner
# --------------------------------------------------------------------------

def test_forecast_axis_grid_is_the_reference_grid():
    kw = dict(name="fc", workload={"preset": "fig3_small", "n_jobs": 60}, platform=16,
              schedulers=("EASY PSUS", "EASY PSUS+Forecast", "FCFS PSAS+Forecast"),
              timeouts=(300, 1800), forecasts=(0, 900))
    port = texp.run(texp.Experiment(**kw), device=CPU).rows
    _same_rows(port, jexp.run(jexp.Experiment(**kw)).rows)
    by = {(r["scheduler"], r["timeout"], r["forecast"]): r for r in port}
    for t in (300, 1800):  # horizon 0: the reactive base, bit for bit
        base = {k: v for k, v in by["EASY PSUS", t, 0].items() if k != "scheduler"}
        assert {k: v for k, v in by["EASY PSUS+Forecast", t, 0].items()
                if k != "scheduler"} == base
        assert by["EASY PSUS", t, 900] == dict(by["EASY PSUS", t, 0], forecast=900)


def test_rl_groups_grid_with_a_reference_checkpoint_is_the_reference_grid(tmp_path):
    mixed_platform_example(16).save(str(tmp_path / "plat.json"))
    ckpt = _save_ckpt(tmp_path / "ckpt", 3, "compact_groups", "group_target_fraction", 9,
                      action_space_size("group_target_fraction", 9, 3),
                      feature_size("compact_groups", 8, 3), grouped=True)
    kw = dict(name="rl", workload={"preset": "fig3_small", "n_jobs": 60},
              platform=str(tmp_path / "plat.json"),
              schedulers=("EASY PSUS", "EASY RL:groups", "FCFS RL:groups"),
              timeouts=(300,), grouped_tables=True, node_order="cheap",
              rl={"checkpoint": ckpt, "decision_interval": 600})
    port = texp.run(texp.Experiment(**kw), device=CPU).rows
    _same_rows(port, jexp.run(jexp.Experiment(**kw)).rows)
    # the agent acted: its rows are not the reactive row
    assert port[1]["total_energy_kwh"] != port[0]["total_energy_kwh"]
    one = texp.Experiment(**dict(kw, schedulers=("EASY RL:groups",)))
    assert texp.run(one, device=CPU).rows == (port[1],)


# --------------------------------------------------------------------------
# the command line and isolation
# --------------------------------------------------------------------------

def test_cli_experiment_writes_run_files_bytes(tmp_path, capsys):
    spec = tmp_path / "exp.json"
    texp.Experiment(name="cli", workload={"preset": "fig3_small", "n_jobs": 30},
                    platform=16, schedulers=("EASY PSUS", "EASY PSAS"), timeouts=(120,),
                    out=str(tmp_path / "out")).save(str(spec))
    result = tsim.main(["--experiment", str(spec), "--device", "cpu"])
    assert len(result.rows) == 2
    printed = capsys.readouterr().out
    assert "# grid: 2 rows, ? compiled program(s)" in printed
    got = {n: (tmp_path / "out" / n).read_bytes() for n in ("metrics.json", "rows.csv")}
    texp.run_file(str(spec), device=CPU)
    for n, data in got.items():
        assert (tmp_path / "out" / n).read_bytes() == data, n


def test_new_modules_import_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.experiments, repro_torch.experiments.runner\n"
        "import repro_torch.launch.sim_serve, repro_torch.launch.shapes\n"
        "import repro_torch.configs.job_profiles\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""
