"""Rule 10 and the in-graph controller over the PyTorch sweep's ``[E]`` rows.

- ``policy.apply_forecast_rows`` in the sweep: Forecast rows with and
  without DVFS (the pre-ramp), each with its own horizon, on dense and
  grouped tables, in one grid with rule 6-9 rows: every row equals the
  port's single run of its scenario bit for bit on every ``SimState``
  field, and the JAX reference's ``engine.sweep`` row (schedule exact;
  energy to rel 1e-5, the mode ledgers to rel 1e-4 on the dense DVFS route,
  ROADMAP Queue 3 item 4). A Forecast row at horizon 0 gives its reactive
  base's schedule and energy bit for bit.
- The config's in-graph controller over rows: the checkpointed policy of
  ``launch/sim`` (its ``rows`` form: one batched forward, a per-row argmax)
  and a plain ``f(s, const)`` run on each row's views give the same grid,
  each RL row equal to the single run with the same controller and each
  non-RL row to its own single run, bit for bit.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.metrics import np_state as j_np_state
from repro.core.metrics import schedule_table as j_schedule_table
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import engine, metrics, sweep
from repro_torch.core import policy as tpol
from repro_torch.core.rl.actions import action_space_size
from repro_torch.core.rl.features import feature_size
from repro_torch.core.types import EngineConfig
from repro_torch.launch import sim as tsim
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_rl_checkpoint import _save_ckpt  # noqa: E402

CPU = "cpu"
SCENARIOS = [
    "EASY PSUS+Forecast",
    {"scheduler": "EASY PSUS+Forecast", "forecast_horizon": 0},
    "EASY PSUS",
    "EASY DVFS+Forecast",
    {"scheduler": "FCFS PSAS+IPM+DVFS+Forecast", "timeout": 60},
    "EASY RL",
    "EASY PSUS+DVFS",
    {"scheduler": "EASY Forecast", "forecast_horizon": 1800},
]
CASES = {
    "dense dvfs": (tplat.dvfs_platform_example, jplat.dvfs_platform_example, False),
    "grouped dvfs": (tplat.dvfs_platform_example, jplat.dvfs_platform_example, True),
    "dense homogeneous": (lambda n: tplat.PlatformSpec(nb_nodes=n),
                          lambda n: jplat.PlatformSpec(nb_nodes=n), False),
}
KW = dict(timeout=300, rl_decision_interval=600, node_order="cheap",
          terminate_overrun=True, forecast_horizon=900)


def _single_cfg(cfg, sc):
    sc = {"scheduler": sc} if isinstance(sc, str) else sc
    base, pol = tpol.from_label(sc["scheduler"])
    return dataclasses.replace(
        cfg, base=base, policy=pol, timeout=sc.get("timeout", cfg.timeout),
        forecast_horizon=sc.get("forecast_horizon", cfg.forecast_horizon))


def _bad_fields(a, b):
    da, db = metrics.np_state(a), metrics.np_state(b)
    return [k for k in da if not (da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k]))]


@pytest.fixture(scope="module", params=sorted(CASES))
def forecast_sweep(request):
    tp_fn, jp_fn, grouped = CASES[request.param]
    plat = tp_fn(16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=40, nb_res=16, seed=5))
    jwl = jgen.generate_workload(jgen.GeneratorConfig(n_jobs=40, nb_res=16, seed=5))
    cfg = EngineConfig(grouped_tables=grouped, **KW)
    batch = sweep.sweep(plat, wl, SCENARIOS, cfg, device=CPU)
    jbatch = jeng.sweep(jp_fn(16), jwl, SCENARIOS, JConfig(grouped_tables=grouped, **KW))
    return request.param, plat, wl, cfg, batch, jbatch


@pytest.mark.parametrize("i", range(len(SCENARIOS)))
def test_forecast_rows_equal_single_runs_and_the_reference(forecast_sweep, i):
    name, plat, wl, cfg, batch, jbatch = forecast_sweep
    single = engine.simulate(plat, wl, _single_cfg(cfg, SCENARIOS[i]), device=CPU)
    row = batch.state_at(i)
    assert not _bad_fields(row, single), (SCENARIOS[i], _bad_fields(row, single))
    jrow = jeng.SimState(*[x[i] for x in jbatch.states])
    np.testing.assert_array_equal(metrics.schedule_table(row), j_schedule_table(jrow))
    a, j = metrics.np_state(row), j_np_state(jrow)
    for k in ("n_batches", "n_switch_on", "n_switch_off", "dvfs_mode", "job_finish",
              "fc_prev_t", "fc_last_arr"):
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)
    np.testing.assert_allclose(a["fc_gap"], j["fc_gap"], rtol=1e-6)
    np.testing.assert_allclose(a["energy"], j["energy"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(a["mode_time"], j["mode_time"], rtol=1e-6)
    mode_rtol = 1e-4 if name.startswith("dense") else 1e-5
    np.testing.assert_allclose(a["mode_energy"], j["mode_energy"], rtol=mode_rtol, atol=1e-3)


def test_horizon_zero_is_the_reactive_base(forecast_sweep):
    *_, batch, _ = forecast_sweep
    fc0, base = metrics.np_state(batch.state_at(1)), metrics.np_state(batch.state_at(2))
    for k in ("job_start", "job_finish", "node_state", "energy", "n_batches",
              "n_switch_on", "n_switch_off", "wait_integral"):
        assert np.array_equal(fc0[k], base[k]), k
    # the predictor ran all the same; at horizon 900 its review ticks add
    # batches
    assert fc0["fc_prev_t"] == fc0["t"]
    assert int(batch.states.n_batches[0]) > int(batch.states.n_batches[2])


def test_forecast_rows_add_their_review_tick_and_take_no_quiet_batch(monkeypatch):
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=20, nb_res=16, seed=2))
    quiet = []
    real = sweep._quiet_batch
    monkeypatch.setattr(sweep, "_quiet_batch",
                        lambda s, g: quiet.append(1) or real(s, g))
    cfg = EngineConfig(timeout=120, forecast_horizon=5000)
    b = sweep.sweep(plat, wl, ["EASY PSUS+Forecast"], cfg, device=CPU)
    assert not quiet
    single = engine.simulate(plat, wl, _single_cfg(cfg, "EASY PSUS+Forecast"), device=CPU)
    assert not _bad_fields(b.state_at(0), single)
    sweep.sweep(plat, wl, ["EASY PSUS"], cfg, device=CPU)
    assert quiet  # the reactive row alone takes quiet batches


# --------------------------------------------------------------------------
# the in-graph controller over rows
# --------------------------------------------------------------------------

CONTROLLER_CASES = {
    "RL:groups": (tplat.mixed_platform_example, "compact_groups",
                  "group_target_fraction", True, 3,
                  ["EASY RL:groups", "FCFS RL:groups", "EASY PSUS",
                   {"scheduler": "EASY RL:groups", "timeout": 60}, "EASY PSAS+IPM"]),
    "RL": (lambda n: tplat.PlatformSpec(nb_nodes=n), "compact", "target_fraction",
           False, 1, ["EASY RL", "EASY PSUS+Forecast", {"scheduler": "FCFS RL",
                                                        "timeout": 900}]),
}


def _checkpoint_policy(tmp_path, name):
    plat_fn, feature, action, grouped, groups, _ = CONTROLLER_CASES[name]
    plat = plat_fn(16)
    ckpt = _save_ckpt(tmp_path / "ckpt", groups, feature, action, 9,
                      action_space_size(action, 9, groups),
                      feature_size(feature, 8, groups), grouped=grouped)
    pol, _ = tsim._resolve_rl_policy(
        tpol.RLController(grouped=grouped), {"rl": {"checkpoint": ckpt}}, plat, CPU)
    return plat, pol


@pytest.mark.parametrize("name", sorted(CONTROLLER_CASES))
def test_controller_rows_equal_single_runs_with_the_same_controller(tmp_path, name):
    plat, pol = _checkpoint_policy(tmp_path, name)
    scenarios = CONTROLLER_CASES[name][-1]
    assert pol.controller.rows is not None
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=30, nb_res=16, seed=11))
    cfg = EngineConfig(policy=pol, grouped_tables=plat.n_groups() > 1,
                       rl_decision_interval=600, timeout=300, node_order="cheap")
    rows_form = sweep.sweep(plat, wl, scenarios, cfg, device=CPU)

    def per_row(s, const):  # a plain controller: no rows form
        return pol.controller(s, const)

    plain_cfg = dataclasses.replace(cfg, policy=dataclasses.replace(pol, controller=per_row))
    plain = sweep.sweep(plat, wl, scenarios, plain_cfg, device=CPU)
    acted = False
    for i, sc in enumerate(scenarios):
        c = _single_cfg(cfg, sc)
        if isinstance(c.policy, tpol.RLController):
            c = dataclasses.replace(c, policy=pol)
        single = engine.simulate(plat, wl, c, device=CPU)
        assert not _bad_fields(rows_form.state_at(i), single), (sc, "rows form")
        assert not _bad_fields(plain.state_at(i), single), (sc, "per row")
        if isinstance(c.policy, tpol.RLController):
            reactive = engine.simulate(plat, wl, dataclasses.replace(
                c, policy=tpol.RLController(grouped=pol.grouped)), device=CPU)
            acted |= int(single.n_switch_off) != int(reactive.n_switch_off)
    assert acted  # the agent's commands changed what the nodes did


def test_controller_arity_under_rl_dvfs_is_checked_over_rows():
    plat = tplat.dvfs_platform_example(16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=10, nb_res=16, seed=0))

    def pair(s, const):
        return torch.zeros_like(s.rl_on_cmd), torch.zeros_like(s.rl_off_cmd)

    cfg = EngineConfig(policy=tpol.RLController(dvfs=True, controller=pair),
                       rl_decision_interval=600)
    with pytest.raises(ValueError, match=r"needs a controller returning \(on, off, mode\)"):
        sweep.sweep(plat, wl, ["EASY RL:dvfs", "EASY PSUS"], cfg, device=CPU)
