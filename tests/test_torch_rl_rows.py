"""Rules 8-9 over a scenario axis in the PyTorch port, and sweep rows that
run them.

``policy.apply_rl_commands_rows`` (global and grouped, and a mixed
``grouped`` gate), ``apply_dvfs_rows`` (the ladder, agent commands and a
mixed ``rl`` gate, with and without ``terminate_overrun``),
``apply_dvfs_modes_rows`` and ``effective_node_speed_rows`` run on E rows of
random states (numpy seeds, N = 16, 64 and 131 nodes of the 3-group DVFS
platform): each row whose gate is on must equal the single-state function
on that row bit for bit, and each row whose gate is off must come back
unchanged. Then whole sweeps whose rows set the rule 8-9 flags (RL without a
controller, the DVFS ladder, RL:dvfs, composed with rules 6-7): every row
equals the port's single run of its scenario bit for bit, and the JAX
reference's ``engine.sweep`` row (schedule exact; energy to rel 1e-5 and
the mode ledgers to rel 1e-4 on the dense DVFS route, ROADMAP Queue 3 item
4). Rule 10 rows and the in-graph controller over rows are
``tests/test_torch_sweep_forecast.py``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.metrics import np_state as j_np_state
from repro.core.metrics import schedule_table as j_schedule_table
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import convert, engine, metrics, sweep
from repro_torch.core import policy as tpol
from repro_torch.core.rl.env import stack_sims
from repro_torch.core.types import RUNNING, EngineConfig
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

CPU = "cpu"
E = 5


def _random_state(seed, n, j=40):
    """numpy arrays of a SimState with every rule 8-9 input drawn at random
    (the generator of tests/test_torch_rules.py at ``n`` nodes)."""
    rng = np.random.default_rng(seed)
    plat = tplat.dvfs_platform_example(n)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=j, nb_res=n, seed=seed))
    d = convert.state_to_arrays(engine.init_state(plat, wl, EngineConfig(), device=CPU))
    t, i32 = 5000, np.int32
    d["t"] = np.asarray(t + rng.integers(0, 50), i32)
    d["node_state"] = rng.integers(0, 5, n).astype(i32)
    d["node_job"] = np.where(rng.random(n) < 0.5, rng.integers(0, j, n), -1).astype(i32)
    d["node_until"] = np.where(rng.random(n) < 0.3, t + rng.integers(1, 900, n),
                               2**30).astype(i32)
    d["node_idle_since"] = rng.integers(0, t, n).astype(i32)
    d["job_status"] = rng.integers(0, 4, j).astype(i32)
    d["job_subtime"] = rng.integers(0, 2 * t, j).astype(i32)
    d["job_res"] = rng.integers(1, max(n // 2, 2), j).astype(i32)
    d["job_start"] = np.where(d["job_status"] >= RUNNING, rng.integers(0, t, j), -1).astype(i32)
    d["job_finish"] = np.where(d["job_status"] >= RUNNING, t + rng.integers(-100, 5000, j),
                               2**30).astype(i32)
    d["job_reqtime"] = rng.integers(100, 8000, j).astype(i32)
    d["job_speed"] = rng.choice(np.asarray([0.25, 0.5, 1.0, 1.5, 2.0, 3.0], np.float32), j)
    d["job_terminated"] = rng.random(j) < 0.1
    d["rl_on_cmd"] = rng.integers(0, n // 3 + 1, 3).astype(i32)
    d["rl_off_cmd"] = rng.integers(0, n // 3 + 1, 3).astype(i32)
    d["rl_mode_cmd"] = rng.integers(-1, 4, 3).astype(i32)
    d["dvfs_mode"] = rng.integers(0, 3, 3).astype(i32)
    return d


def _rows(seed, n):
    """(E single states, their [E] batch, the single const, the grid)."""
    const = engine.make_const(tplat.dvfs_platform_example(n), EngineConfig(), device=CPU)
    singles = [convert.state_from_arrays(_random_state(seed * 100 + e, n), device=CPU)
               for e in range(E)]
    grid = sweep.make_grid([const] * E, CPU)
    return singles, stack_sims(singles), const, grid


def _row(s, e):
    return engine.SimState(*[x[e] for x in s])


def _assert_rows(batched, wants):
    """Row e of ``batched`` == ``wants[e]``, every field bit for bit."""
    for e, want in enumerate(wants):
        got = convert.state_to_arrays(_row(batched, e))
        for k, v in convert.state_to_arrays(want).items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (e, k)


GATES = {"all": [True] * E, "mixed": [True, False, True, True, False]}


def _gate(name):
    g = GATES[name]
    return True if all(g) else torch.tensor(g)


@pytest.mark.parametrize("n", [16, 64, 131])
@pytest.mark.parametrize("gate", ["all", "mixed"])
@pytest.mark.parametrize("grouped", ["global", "grouped", "mixed"])
def test_apply_rl_commands_rows_equal_single(n, gate, grouped):
    singles, batch, const, grid = _rows(1, n)
    gmask = {"global": [False] * E, "grouped": [True] * E,
             "mixed": [False, True, True, False, True]}[grouped]
    gg = (False if not any(gmask) else True if all(gmask) else torch.tensor(gmask))
    out = tpol.apply_rl_commands_rows(batch, grid.const, gg, _gate(gate))
    _assert_rows(out, [
        tpol.apply_rl_commands(s, const, grouped=gmask[e]) if GATES[gate][e] else s
        for e, s in enumerate(singles)
    ])


@pytest.mark.parametrize("n", [16, 64, 131])
@pytest.mark.parametrize("gate", ["all", "mixed"])
@pytest.mark.parametrize("rl", ["ladder", "commands", "mixed"])
@pytest.mark.parametrize("overrun", [False, True])
def test_apply_dvfs_rows_equal_single(n, gate, rl, overrun):
    singles, batch, const, grid = _rows(2, n)
    rmask = {"ladder": [False] * E, "commands": [True] * E,
             "mixed": [True, True, False, False, True]}[rl]
    rg = (False if not any(rmask) else True if all(rmask) else torch.tensor(rmask))
    out = tpol.apply_dvfs_rows(batch, grid.const, _gate(gate), rg, overrun)
    _assert_rows(out, [
        tpol.apply_dvfs(s, const, terminate_overrun=overrun, rl=rmask[e])
        if GATES[gate][e] else s
        for e, s in enumerate(singles)
    ])


@pytest.mark.parametrize("n", [16, 131])
@pytest.mark.parametrize("gate", ["all", "mixed"])
def test_dvfs_modes_and_speeds_rows_equal_single(n, gate):
    singles, batch, const, grid = _rows(3, n)
    rng = np.random.default_rng(n)
    target = torch.from_numpy(rng.integers(0, 3, (E, 3)).astype(np.int32))
    out = tpol.apply_dvfs_modes_rows(batch, grid.const, target, _gate(gate), True)
    _assert_rows(out, [
        tpol.apply_dvfs_modes(s, const, target[e], True, True) if GATES[gate][e] else s
        for e, s in enumerate(singles)
    ])
    speeds = tpol.effective_node_speed_rows(grid.const, target, _gate(gate))
    for e in range(E):
        want = tpol.effective_node_speed(const, target[e], GATES[gate][e])
        assert torch.equal(speeds[e], want), e


# --------------------------------------------------------------------------
# sweep rows under rules 8-9
# --------------------------------------------------------------------------

LABELS = ["EASY DVFS", "EASY PSUS+DVFS", "EASY RL", "FCFS PSAS+IPM+DVFS",
          "EASY RL:dvfs", "FCFS PSUS", "EASY RL:groups"]
CASES = {
    "dense dvfs": (tplat.dvfs_platform_example, jplat.dvfs_platform_example, False),
    "grouped dvfs": (tplat.dvfs_platform_example, jplat.dvfs_platform_example, True),
    "dense homogeneous": (lambda n: tplat.PlatformSpec(nb_nodes=n),
                          lambda n: jplat.PlatformSpec(nb_nodes=n), False),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def rule89_sweep(request):
    tp_fn, jp_fn, grouped = CASES[request.param]
    kw = dict(timeout=300, grouped_tables=grouped, rl_decision_interval=600,
              node_order="cheap", terminate_overrun=True)
    tplat_, jplat_ = tp_fn(16), jp_fn(16)
    twl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=40, nb_res=16, seed=5))
    jwl = jgen.generate_workload(jgen.GeneratorConfig(n_jobs=40, nb_res=16, seed=5))
    cfg = EngineConfig(**kw)
    batch = sweep.sweep(tplat_, twl, LABELS, cfg, device=CPU)
    jbatch = jeng.sweep(jplat_, jwl, LABELS, JConfig(**kw))
    return request.param, tplat_, twl, cfg, batch, jbatch


@pytest.mark.parametrize("i", range(len(LABELS)))
def test_rule89_sweep_rows_equal_single_runs_and_the_reference(rule89_sweep, i):
    name, plat, wl, cfg, batch, jbatch = rule89_sweep
    base, pol = tpol.from_label(LABELS[i])
    single = engine.simulate(plat, wl, dataclasses.replace(cfg, base=base, policy=pol),
                             device=CPU)
    row = batch.state_at(i)
    a, b = metrics.np_state(row), metrics.np_state(single)
    bad = [k for k in a if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]))]
    assert not bad, (LABELS[i], bad)
    jrow = jeng.SimState(*[x[i] for x in jbatch.states])
    np.testing.assert_array_equal(metrics.schedule_table(row), j_schedule_table(jrow))
    j = j_np_state(jrow)
    for k in ("n_batches", "n_switch_on", "n_switch_off", "dvfs_mode", "job_finish"):
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)
    np.testing.assert_allclose(a["energy"], j["energy"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(a["mode_time"], j["mode_time"], rtol=1e-6)
    mode_rtol = 1e-4 if name.startswith("dense") else 1e-5
    np.testing.assert_allclose(a["mode_energy"], j["mode_energy"], rtol=mode_rtol,
                               atol=1e-3)


def test_rule89_rows_turn_quiet_batching_off_per_row():
    """A grid of an RL row and a PSUS row runs the full body whenever the RL
    row is live (it is never quiet), yet the PSUS row still equals its
    single run, which takes quiet batches."""
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=30, nb_res=16, seed=9))
    cfg = EngineConfig(timeout=120, rl_decision_interval=900)
    b = sweep.sweep(plat, wl, ["EASY RL", "EASY PSUS"], cfg, device=CPU)
    for i, label in enumerate(["EASY RL", "EASY PSUS"]):
        base, pol = tpol.from_label(label)
        s = engine.simulate(plat, wl, dataclasses.replace(cfg, base=base, policy=pol),
                            device=CPU)
        assert metrics.np_state(b.state_at(i))["n_batches"] == int(s.n_batches)
        np.testing.assert_array_equal(metrics.schedule_table(b.state_at(i)),
                                      metrics.schedule_table(s))


# --------------------------------------------------------------------------
# the RL registries over [B] rows
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 131])
@pytest.mark.parametrize("name", ["compact", "queue_window", "compact_groups",
                                  "compact_dvfs", "compact_forecast"])
def test_feature_extractors_on_rows_equal_single(n, name):
    from repro_torch.core.rl.features import extract, feature_size

    singles, batch, const, grid = _rows(4, n)
    obs = extract(name, batch, grid.const, 8)
    assert obs.shape == (E, feature_size(name, 8, 3)) and obs.dtype == torch.float32
    for e, s in enumerate(singles):
        assert torch.equal(obs[e], extract(name, s, const, 8)), e


@pytest.mark.parametrize("name", ["waste_wait", "group_waste_wait", "energy_wait",
                                  "energy_only", "wait_only"])
def test_rewards_on_rows_equal_single(name):
    from repro_torch.core.rl.rewards import REWARDS, RewardWeights

    singles, batch, const, grid = _rows(5, 64)
    rng = np.random.default_rng(5)
    new = batch._replace(
        energy=batch.energy + torch.from_numpy(rng.random((E, 3, 5)).astype(np.float32)) * 1e4,
        wait_integral=batch.wait_integral + torch.from_numpy(
            rng.random(E).astype(np.float32)) * 1e3)
    w = RewardWeights(w_energy=0.7, w_wait=1.3)
    r = REWARDS[name](batch, new, grid.const, w)
    for e, s in enumerate(singles):
        assert torch.equal(r[e], REWARDS[name](s, _row(new, e), const, w)), e


@pytest.mark.parametrize("name", ["delta", "target_fraction", "group_target_fraction",
                                  "group_mode"])
def test_translators_on_rows_equal_single(name):
    from repro_torch.core.rl.actions import ACTION_TRANSLATORS, full_commands

    singles, batch, const, grid = _rows(6, 64)
    n_levels = {"delta": 5, "group_mode": 3}.get(name, 9)
    actions = torch.tensor([0, 3, 7, 11, 20], dtype=torch.int32)
    fn = ACTION_TRANSLATORS[name]
    got = full_commands(batch, fn(batch, grid.const, actions, n_levels))
    for e, s in enumerate(singles):
        want = full_commands(s, fn(s, const, int(actions[e]), n_levels))
        for g, w in zip(got, want):
            assert torch.equal(g[e], w), (e, g[e], w)
