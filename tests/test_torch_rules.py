"""Rules 8-10 of the PyTorch port against their JAX twins, and the in-graph
controller hook.

Each rule function (``apply_rl_commands`` global and grouped,
``apply_dvfs`` on the ladder and on agent commands, ``apply_dvfs_modes``
with and without ``terminate_overrun``, ``forecast_pressure`` and
``apply_forecast`` with and without the DVFS pre-ramp) runs on random states
made from a numpy seed (N = 64 nodes in G = 3 groups with three DVFS modes)
in both engines. Every field of the returned state is compared bit for bit:
the integer fields, and the f32 fields the cross-engine contract pins (the
EWMA, the realized speeds, the mode vector's effect on finishes).

The JAX twin runs op by op, each op rounding once, as the contract and the
oracle spell it. Under ``jax.jit`` the CPU compiler contracts the EWMA
``a*obs + (1-a)*ewma`` into a fused multiply-add, which can move ``fc_gap``
by one ulp (:func:`test_ewma_rounds_twice_like_the_oracle` has a case);
the port rounds twice, like the oracle.

Then whole simulations with a fixed-action controller: the same translator
(``delta_nodes``, ``group_target_fraction`` under ``RL:groups``,
``group_mode`` under ``RL:dvfs``) drives the port's engine and the JAX
engine, which must give the same schedule, batches and switch counts and
energy to rel 1e-5; the controller arity guard; the RL tick's batches; and
the dense ledger-kernel gate under DVFS.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import metrics as jmet
from repro.core import policy as jpol
from repro.core.rl import actions as jact
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import convert
from repro_torch.core import engine as teng
from repro_torch.core import metrics as tmet
from repro_torch.core import policy as tpol
from repro_torch.core.rl import actions as tact
from repro_torch.core.types import RUNNING, EngineConfig as TConfig
from repro_torch.kernels import event_fuse
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

N, J = 64, 48


def _consts(**cfg_kw):
    """(JAX const, port const) of the 64-node DVFS platform (G = 3, M = 3)."""
    jp, tp = jplat.dvfs_platform_example(N), tplat.dvfs_platform_example(N)
    jc = JConfig(**cfg_kw)
    tc = TConfig(**cfg_kw)
    return (jeng.make_const(jp, jc, specialize=True),
            teng.make_const(tp, tc, device="cpu"))


def _random_state(seed):
    """numpy arrays of a SimState with every rule 8-10 input drawn at
    random: node states and reservations, idle times, job statuses, speeds
    and finishes, pending commands (modes up to one past the table, to be
    clamped), DVFS modes and the forecast predictor."""
    rng = np.random.default_rng(seed)
    tp = tplat.dvfs_platform_example(N)
    tw = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=J, nb_res=N, seed=seed))
    d = convert.state_to_arrays(teng.init_state(tp, tw, TConfig(), device="cpu"))
    t = 5000
    i32 = np.int32
    d["t"] = np.asarray(t, i32)
    d["node_state"] = rng.integers(0, 5, N).astype(i32)
    d["node_job"] = np.where(rng.random(N) < 0.5, rng.integers(0, J, N), -1).astype(i32)
    d["node_until"] = np.where(rng.random(N) < 0.3, t + rng.integers(1, 900, N), 2**30).astype(i32)
    d["node_idle_since"] = rng.integers(0, t, N).astype(i32)
    d["job_status"] = rng.integers(0, 4, J).astype(i32)
    d["job_subtime"] = rng.integers(0, 2 * t, J).astype(i32)
    d["job_res"] = rng.integers(1, N // 2, J).astype(i32)
    d["job_start"] = np.where(d["job_status"] >= RUNNING, rng.integers(0, t, J), -1).astype(i32)
    d["job_finish"] = np.where(d["job_status"] >= RUNNING, t + rng.integers(-100, 5000, J),
                               2**30).astype(i32)
    d["job_reqtime"] = rng.integers(100, 8000, J).astype(i32)
    d["job_speed"] = rng.choice(np.asarray([0.25, 0.5, 1.0, 1.5, 2.0, 3.0], np.float32), J)
    d["job_terminated"] = rng.random(J) < 0.1
    d["rl_on_cmd"] = rng.integers(0, N // 3, 3).astype(i32)
    d["rl_off_cmd"] = rng.integers(0, N // 3, 3).astype(i32)
    d["rl_mode_cmd"] = rng.integers(-1, 4, 3).astype(i32)
    d["dvfs_mode"] = rng.integers(0, 3, 3).astype(i32)
    d["fc_gap"] = np.float32(rng.uniform(0.5, 900.0))
    d["fc_res"] = np.float32(rng.uniform(0.0, 20.0))
    d["fc_last_arr"] = np.asarray(rng.integers(0, t), i32)
    d["fc_prev_t"] = np.asarray(rng.integers(-1, t), i32)
    return d


def _both(d):
    return (jeng.SimState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.state_from_arrays(d, device="cpu"))


def _assert_states_equal(js, ts):
    want = {k: np.asarray(v) for k, v in js._asdict().items()}
    got = convert.state_to_arrays(ts)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _run_rule(jfn, tfn, seed, **cfg_kw):
    jconst, tconst = _consts(**cfg_kw)
    js, ts = _both(_random_state(seed))
    return jfn(js, jconst), tfn(ts, tconst)


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("grouped", [False, True])
def test_apply_rl_commands_matches_reference(grouped, seed):
    js, ts = _run_rule(
        lambda s, c: jpol.apply_rl_commands(s, c, grouped=grouped),
        lambda s, c: tpol.apply_rl_commands(s, c, grouped=grouped),
        seed,
    )
    _assert_states_equal(js, ts)
    assert not ts.rl_on_cmd.any() and not ts.rl_off_cmd.any()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rl", [False, True])
@pytest.mark.parametrize("overrun", [False, True])
def test_apply_dvfs_matches_reference(rl, overrun, seed):
    js, ts = _run_rule(
        lambda s, c: jpol.apply_dvfs(s, c, terminate_overrun=overrun, rl=rl),
        lambda s, c: tpol.apply_dvfs(s, c, terminate_overrun=overrun, rl=rl),
        seed,
    )
    _assert_states_equal(js, ts)
    assert (ts.rl_mode_cmd == -1).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("overrun", [False, True])
@pytest.mark.parametrize("enabled", ["true", "device-true", "device-false"])
def test_apply_dvfs_modes_matches_reference(overrun, enabled, seed):
    """The install + rescale with a random target, ``enabled`` a Python
    True or a device scalar (rule 10's pre-ramp gate)."""
    import torch

    target = np.random.default_rng(seed + 100).integers(0, 3, 3).astype(np.int32)
    j_en = True if enabled == "true" else jnp.asarray(enabled == "device-true")
    t_en = True if enabled == "true" else torch.tensor(enabled == "device-true")
    js, ts = _run_rule(
        lambda s, c: jpol.apply_dvfs_modes(s, c, jnp.asarray(target), j_en, overrun),
        lambda s, c: tpol.apply_dvfs_modes(s, c, torch.from_numpy(target), t_en, overrun),
        seed,
    )
    _assert_states_equal(js, ts)


@pytest.mark.parametrize("horizon,gap", [(1800, None), (10**9, 1.0), (0, None),
                                          (900, 2.0**30)])
def test_forecast_pressure_matches_reference(horizon, gap):
    """Including an extreme horizon over a 1 s gap (saturates at N), a zero
    horizon, and a predictor still at its INF_TIME init."""
    d = _random_state(7)
    if gap is not None:
        d["fc_gap"] = np.float32(gap)
        d["fc_res"] = np.float32(50.0)
    jconst, tconst = _consts(forecast_horizon=horizon)
    js, ts = _both(d)
    want = int(jpol.forecast_pressure(js, jconst))
    got = tpol.forecast_pressure(ts, tconst)
    assert got.dtype == teng.I32 and int(got) == want
    if horizon == 10**9:
        assert want == N


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ramp", [False, True])
@pytest.mark.parametrize("alpha", [0.25, 0.9])
def test_apply_forecast_matches_reference(ramp, alpha, seed):
    js, ts = _run_rule(
        lambda s, c: jpol.apply_forecast(s, c, terminate_overrun=True, dvfs_ramp=ramp),
        lambda s, c: tpol.apply_forecast(s, c, terminate_overrun=True, dvfs_ramp=ramp),
        seed, forecast_horizon=1800, forecast_alpha=alpha,
    )
    _assert_states_equal(js, ts)


def test_ewma_rounds_twice_like_the_oracle():
    """The EWMA of seed 0 against the oracle's numpy f32 expression (two
    roundings), where a fused multiply-add gives the next f32: the port and
    the op-by-op JAX rule give the oracle's value; the jitted JAX rule gives
    one of the two (the fused one where the CPU compiler contracts)."""
    d = _random_state(0)
    jconst, tconst = _consts(forecast_horizon=1800, forecast_alpha=0.25)
    js, ts = _both(d)
    f32 = np.float32
    t = int(d["t"])
    newly = d["job_exists"] & (d["job_subtime"] <= t) & (d["job_subtime"] > d["fc_prev_t"])
    gap_obs = f32(t - d["fc_last_arr"]) / f32(max(int(newly.sum()), 1))
    a = f32(0.25)
    oracle = a * gap_obs + (f32(1.0) - a) * d["fc_gap"]
    fused = f32(np.float64(a * gap_obs) + np.float64(f32(1.0) - a) * np.float64(d["fc_gap"]))
    assert oracle != fused
    assert float(tpol.apply_forecast(ts, tconst).fc_gap) == oracle
    assert float(jpol.apply_forecast(js, jconst).fc_gap) == oracle
    jitted = jax.jit(lambda s: jpol.apply_forecast(s, jconst))(js)
    assert float(jitted.fc_gap) in (oracle, fused)


# --------------------------------------------------------------------------
# the in-graph controller hook, through simulate
# --------------------------------------------------------------------------

def _wl(n, seed=5, n_jobs=50):
    cfg = dict(n_jobs=n_jobs, nb_res=n, seed=seed, overrun_prob=0.2)
    return (jgen.generate_workload(jgen.GeneratorConfig(**cfg)),
            tgen.generate_workload(tgen.GeneratorConfig(**cfg)))


CONTROLLERS = {
    # name: (platform maker name, label, translator name, action, n_levels)
    "delta": ("PlatformSpec", "EASY RL", "delta", 3, 5),
    "target_fraction": ("PlatformSpec", "FCFS RL", "target_fraction", 4, 9),
    "group_target_fraction": ("mixed_platform_example", "EASY RL:groups",
                              "group_target_fraction", 11, 9),
    "group_mode": ("dvfs_platform_example", "EASY RL:dvfs", "group_mode", 8, 3),
}


def _controller_run(name, **kw):
    maker, label, tr, action, n_levels = CONTROLLERS[name]
    n = 16
    if maker == "PlatformSpec":
        jp, tp = jplat.PlatformSpec(nb_nodes=n), tplat.PlatformSpec(nb_nodes=n)
    else:
        jp, tp = getattr(jplat, maker)(n), getattr(tplat, maker)(n)
    jw, tw = _wl(n)
    jb, jpo = jpol.from_label(label)
    tb, tpo = tpol.from_label(label)

    def jctrl(s, c):
        return jact.ACTION_TRANSLATORS[tr](s, c, jnp.int32(action), n_levels)

    def tctrl(s, c):
        return tact.ACTION_TRANSLATORS[tr](s, c, action, n_levels)

    shared = dict(rl_decision_interval=600, node_order="cheap",
                  terminate_overrun=True, timeout=300, **kw)
    jc = JConfig(base=jb, policy=dataclasses.replace(jpo, controller=jctrl), **shared)
    tc = TConfig(base=tb, policy=dataclasses.replace(tpo, controller=tctrl), **shared)
    return (jeng.simulate(jp, jw, jc), teng.simulate(tp, tw, tc, device="cpu"), jp, tp)


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_fixed_action_controller_matches_reference(name):
    js, ts, jp, tp = _controller_run(name)
    np.testing.assert_array_equal(tmet.schedule_table(ts), jmet.schedule_table(js))
    for fld in ("n_batches", "n_switch_on", "n_switch_off", "dvfs_mode", "t"):
        np.testing.assert_array_equal(
            getattr(ts, fld).numpy(), np.asarray(getattr(js, fld)), err_msg=fld)
    m_t, m_j = tmet.metrics_from_state(ts, tp), jmet.metrics_from_state(js, jp)
    assert m_t.total_energy_j == pytest.approx(m_j.total_energy_j, rel=1e-5)
    np.testing.assert_allclose(m_t.mode_residency_s, m_j.mode_residency_s, rtol=1e-5)
    np.testing.assert_allclose(m_t.energy_by_mode_j, m_j.energy_by_mode_j, rtol=1e-5)
    assert m_t.utilization == pytest.approx(m_j.utilization, rel=1e-5)
    if name == "group_mode":  # action 8 = group 2 at mode 2 (turbo)
        assert ts.dvfs_mode.tolist() == [0, 0, 2]
    else:
        assert int(ts.n_switch_off) > 0


@pytest.mark.parametrize("name,n_levels,n_groups", [
    ("delta", None, 1), ("delta", 3, 1), ("target_fraction", None, 3),
    ("group_target_fraction", 9, 3), ("group_mode", 3, 3)])
def test_action_space_sizes_match_reference(name, n_levels, n_groups):
    assert tact.action_space_size(name, n_levels, n_groups) == \
        jact.action_space_size(name, n_levels, n_groups)
    assert tact.GROUP_ACTIONS == jact.GROUP_ACTIONS
    assert tact.DVFS_ACTIONS == jact.DVFS_ACTIONS
    assert set(tact.ACTION_TRANSLATORS) == set(jact.ACTION_TRANSLATORS)


def test_group_mode_needs_the_mode_table_width():
    with pytest.raises(ValueError, match="n_levels"):
        tact.action_space_size("group_mode", None, 3)


def test_dvfs_controller_must_return_modes():
    tp = tplat.dvfs_platform_example(16)
    _, tw = _wl(16, n_jobs=5)
    cfg = TConfig(policy=tpol.RLController(
        dvfs=True, controller=lambda s, c: (s.rl_on_cmd * 0, s.rl_off_cmd * 0)))
    with pytest.raises(ValueError, match=r"\(on, off, mode\)"):
        teng.simulate(tp, tw, cfg, device="cpu")


@pytest.mark.parametrize("interval", [None, 600, 3600])
def test_rl_tick_adds_the_reference_batches(interval):
    """Rule 8 with no controller and no pending command changes nothing but
    the clock: the decision tick adds the same batches as in the reference,
    and without an interval the run is the AlwaysOn run."""
    jp, tp = jplat.PlatformSpec(nb_nodes=16), tplat.PlatformSpec(nb_nodes=16)
    jw, tw = _wl(16, seed=2, n_jobs=30)
    jc = JConfig(base=jpol.from_label("EASY RL")[0], policy=jpol.RLController(),
                 rl_decision_interval=interval)
    tc = TConfig(base=tpol.from_label("EASY RL")[0], policy=tpol.RLController(),
                 rl_decision_interval=interval)
    js = jeng.simulate(jp, jw, jc)
    ts = teng.simulate(tp, tw, tc, device="cpu")
    assert int(ts.n_batches) == int(js.n_batches)
    np.testing.assert_array_equal(tmet.schedule_table(ts), jmet.schedule_table(js))
    base = teng.simulate(tp, tw, TConfig(policy=tpol.AlwaysOn()), device="cpu")
    np.testing.assert_array_equal(tmet.schedule_table(ts), tmet.schedule_table(base))
    if interval is None:
        assert int(ts.n_batches) == int(base.n_batches)
    else:
        assert int(ts.n_batches) > int(base.n_batches)


# --------------------------------------------------------------------------
# the dense ledger-kernel gate, and what check_supported accepts
# --------------------------------------------------------------------------

def test_single_group_dvfs_takes_the_per_node_route(monkeypatch):
    """``event_fuse_ledger`` knows only the base watts, so a dense
    single-group run under DVFS must not call it, even with
    ``fused_kernel=True``; the same run without DVFS does, once a batch."""
    calls = []
    real = event_fuse.event_fuse_ledger

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(event_fuse, "event_fuse_ledger", spy)
    tp = tplat.PlatformSpec(nb_nodes=8, dvfs_profiles=(
        tplat.DvfsProfile("eco", power=120.0, speed=0.5),
        tplat.DvfsProfile("turbo", power=250.0, speed=2.0)))
    assert tp.n_groups() == 1
    _, tw = _wl(8, n_jobs=30)
    base, pol = tpol.from_label("EASY PSUS+DVFS")
    cfg = TConfig(base=base, policy=pol, timeout=120, fused_kernel=True)
    s = teng.simulate(tp, tw, cfg, device="cpu")
    assert calls == [] and int(s.n_batches) > 0
    assert float(s.mode_time.sum()) > 0.0
    plain = teng.simulate(tp, tw, dataclasses.replace(cfg, fused_kernel=False),
                          device="cpu")
    for fld in ("job_start", "job_finish", "energy", "mode_time", "mode_energy"):
        np.testing.assert_array_equal(getattr(s, fld).numpy(),
                                      getattr(plain, fld).numpy(), err_msg=fld)
    nodvfs = teng.simulate(
        tp, tw, dataclasses.replace(cfg, policy=tpol.TimeoutSleep()), device="cpu")
    assert len(calls) == int(nodvfs.n_batches)


@pytest.mark.parametrize(
    "label", tpol.scheduler_labels(include_rl=True, include_dvfs=True,
                                   include_forecast=True)
    + ("EASY DVFS+Forecast", "EASY RL:groups+DVFS"))
def test_check_supported_accepts_every_rule(label):
    base, pol = tpol.from_label(label)
    teng.check_supported(TConfig(base=base, policy=pol))
    if isinstance(pol, tpol.RLController):
        ctrl = dataclasses.replace(
            pol, controller=lambda s, c: (s.rl_on_cmd, s.rl_off_cmd))
        teng.check_supported(TConfig(base=base, policy=ctrl))
