"""The legacy event loop (``EngineConfig(fused_events=False)``) in the
PyTorch port, on the CPU.

Under the legacy loop ``next_time`` decides each batch and gives its time,
``accrue_energy`` gathers the draw itself (per node on the dense route, the
occupancy and its contraction on the grouped route), no batch is quiet and
no event kernel runs: the reference's baseline loop
(``repro.core.engine.run_sim``, ``fused_events=False``). Each case of the
reference's ``tests/test_hot_loop.py`` runs here, and the port's legacy run
is held against:

- the port's fused run: every ``SimState`` field bit for bit (so the
  schedule table and ``SimMetrics`` too);
- the JAX reference's legacy and fused runs (``specialize=False``, the
  traced program the reference documents as bit-exact with the specialized
  one, so a grid of labels compiles once a loop): the schedule table,
  batch and switch counts exactly, total and wasted energy to rel 1e-5;
- the port's copy of the oracle (``core/ref/pydes.py``): the schedule
  table exactly, total energy to rel 1e-5 (the bar of the reference's
  SEMANTICS.md §Numerics).

The sweep's legacy rows are held row by row against its fused rows, the
port's legacy single runs, the oracle and the reference's legacy
``repro.core.engine.sweep`` (whose own ``test_fused_bit_exact_traced_sweep``
holds its fused sweep to it); the dense single and the grouped
``[B]`` envs step by step against the reference's env under the legacy
loop (integer state and the schedule exact, energy rel 1e-5, observations
atol 1e-6). The legacy loop arms no quiet batch and reads the device no
more often a batch than the fused loop's full batch does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import metrics as jmet
from repro.core import policy as jpol
from repro.core.rl import a2c as ja2c
from repro.core.rl import env as jenv
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro.workloads import workload as jwork
from repro_torch.core import engine, metrics, sweep
from repro_torch.core import policy as tpol
from repro_torch.core.ref.pydes import run_pydes
from repro_torch.core.rl import a2c, env
from repro_torch.core.types import EngineConfig
from repro_torch.kernels import event_fuse
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat
from repro_torch.workloads import workload as twork

CPU = "cpu"
ENERGY_REL = 1e-5
OBS_ATOL = 1e-6
LABELS = list(tpol.scheduler_labels())  # FCFS/EASY x PSUS/PSAS/PSAS+IPM/AlwaysOn
SIX = [label for label in LABELS if "AlwaysOn" not in label]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread, beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the cases

def _generated(n_nodes, **gen):
    cfg = dict(nb_res=n_nodes, **gen)
    return (tgen.generate_workload(tgen.GeneratorConfig(**cfg)),
            jgen.generate_workload(jgen.GeneratorConfig(**cfg)))


def _sleep_cycle():
    arrays = dict(res=[4, 8, 4, 8, 4, 8], subtime=[0, 700, 1400, 2100, 2800, 3500],
                  runtime=[50, 60, 50, 60, 50, 60], nb_res=16)
    return (twork.workload_from_arrays(**arrays), jwork.workload_from_arrays(**arrays))


# name: (platform maker, maker args, workload maker, label, config keywords)
CASES = {
    **{f"16 nodes {label}": ("PlatformSpec", dict(nb_nodes=16),
                             lambda: _generated(16, n_jobs=80, seed=5, overrun_prob=0.2),
                             label, dict(timeout=120, terminate_overrun=True))
       for label in LABELS},
    "mixed cheap": ("mixed_platform_example", (12,),
                    lambda: _generated(12, n_jobs=40, seed=2), "EASY PSUS",
                    dict(timeout=100, node_order="cheap")),
    "sleep cycle": ("PlatformSpec", dict(nb_nodes=16, t_switch_on=40, t_switch_off=60),
                    _sleep_cycle, "EASY PSUS", dict(timeout=10)),
    "grouped EASY PSUS": ("mixed_platform_example", (16,),
                          lambda: _generated(16, n_jobs=40, seed=3, overrun_prob=0.2),
                          "EASY PSUS", dict(timeout=300, grouped_tables=True,
                                            terminate_overrun=True, node_order="cheap")),
    "grouped FCFS PSAS+IPM": ("mixed_platform_example", (16,),
                              lambda: _generated(16, n_jobs=40, seed=3, overrun_prob=0.2),
                              "FCFS PSAS+IPM",
                              dict(timeout=300, grouped_tables=True,
                                   terminate_overrun=True, node_order="cheap")),
    "DVFS": ("dvfs_platform_example", (16,),
             lambda: _generated(16, n_jobs=40, seed=4, overrun_prob=0.2), "EASY DVFS",
             dict(timeout=300, terminate_overrun=True, node_order="cheap")),
    "Forecast": ("dvfs_platform_example", (16,),
                 lambda: _generated(16, n_jobs=40, seed=4, overrun_prob=0.2),
                 "EASY PSUS+Forecast",
                 dict(timeout=300, terminate_overrun=True, node_order="cheap",
                      forecast_horizon=900)),
    "RL tick": ("dvfs_platform_example", (16,),
                lambda: _generated(16, n_jobs=40, seed=4, overrun_prob=0.2), "EASY RL",
                dict(timeout=300, terminate_overrun=True, node_order="cheap",
                     rl_decision_interval=600)),
}


def _platforms(name):
    maker, args, *_ = CASES[name]
    if isinstance(args, dict):
        return getattr(tplat, maker)(**args), getattr(jplat, maker)(**args)
    return getattr(tplat, maker)(*args), getattr(jplat, maker)(*args)


def _configs(name):
    _, _, _, label, kw = CASES[name]
    (tb, tp), (jb, jp) = tpol.from_label(label), jpol.from_label(label)
    return EngineConfig(base=tb, policy=tp, **kw), JConfig(base=jb, policy=jp, **kw)


@functools.lru_cache(maxsize=None)
def _runs(name):
    """The port's legacy and fused runs, the reference's legacy and fused
    runs, and the case's inputs."""
    tplat_, jplat_ = _platforms(name)
    twl, jwl = CASES[name][2]()
    tcfg, jcfg = _configs(name)
    legacy = dataclasses.replace(tcfg, fused_events=False)
    out = {"inputs": (tplat_, twl, tcfg)}
    engine.HOST_SYNCS = 0
    out["legacy"] = engine.simulate(tplat_, twl, legacy, device=CPU)
    out["legacy_syncs"] = engine.HOST_SYNCS
    engine.HOST_SYNCS = 0
    out["fused"] = engine.simulate(tplat_, twl, tcfg, device=CPU)
    out["fused_syncs"] = engine.HOST_SYNCS
    for key, fused in (("j_legacy", False), ("j_fused", True)):
        out[key] = jeng.simulate(jplat_, jwl, dataclasses.replace(jcfg, fused_events=fused),
                                 specialize=False)
    return out


def _np(s):
    return metrics.np_state(s)


def _differing_fields(a, b):
    da, db = _np(a), _np(b)
    return [k for k in da if not (da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k]))]


# ---------------------------------------------------- single runs, each case

@pytest.mark.parametrize("name", list(CASES))
def test_legacy_equals_the_fused_run_bit_for_bit(name):
    r = _runs(name)
    assert _differing_fields(r["legacy"], r["fused"]) == []
    plat = r["inputs"][0]
    assert (metrics.metrics_from_state(r["legacy"], plat).row()
            == metrics.metrics_from_state(r["fused"], plat).row())


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ref", ["j_legacy", "j_fused"])
def test_legacy_equals_the_jax_runs(name, ref):
    r = _runs(name)
    plat = r["inputs"][0]
    got, want = r["legacy"], r[ref]
    np.testing.assert_array_equal(metrics.schedule_table(got), jmet.schedule_table(want))
    for fld in ("t", "n_batches", "n_switch_on", "n_switch_off", "dvfs_mode", "truncated"):
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)), err_msg=fld)
    mt = metrics.metrics_from_state(got, plat)
    mj = jmet.metrics_from_state(want, _platforms(name)[1])
    assert mt.makespan_s == mj.makespan_s and mt.n_terminated == mj.n_terminated
    assert mt.total_energy_j == pytest.approx(mj.total_energy_j, rel=ENERGY_REL)
    assert mt.wasted_energy_j == pytest.approx(mj.wasted_energy_j, rel=ENERGY_REL)


@pytest.mark.parametrize("name", list(CASES))
def test_legacy_equals_the_oracle(name):
    r = _runs(name)
    plat, wl, cfg = r["inputs"]
    m_o, des = run_pydes(plat, wl, dataclasses.replace(cfg, fused_events=False))
    np.testing.assert_array_equal(metrics.schedule_table(r["legacy"]), des.schedule_table())
    m = metrics.metrics_from_state(r["legacy"], plat)
    assert m.total_energy_j == pytest.approx(m_o.total_energy_j, rel=ENERGY_REL)
    assert m.makespan_s == m_o.makespan_s


def test_the_cases_sleep_cycle_and_switch():
    """The sleep-cycling trace sleep-cycles (so the fused run's quiet
    batches were on its path), and the DVFS case leaves the base mode."""
    assert int(_runs("sleep cycle")["legacy"].n_switch_off) >= 8
    assert int(_runs("16 nodes EASY PSUS")["legacy"].n_switch_off) > 0
    m = metrics.metrics_from_state(_runs("DVFS")["legacy"], _runs("DVFS")["inputs"][0])
    assert sum(row[0] + row[2] for row in m.mode_residency_s) > 0


@pytest.mark.parametrize("name", ["sleep cycle", "16 nodes EASY PSUS", "16 nodes FCFS AlwaysOn",
                                  "grouped EASY PSUS"])
def test_a_legacy_batch_reads_the_device_no_more_than_a_fused_one(name):
    """Both loops read once an iteration and once a scheduler pass: 2 a
    full batch. The fused loop's quiet batches skip the pass (1 read), so
    its total is at most the legacy loop's; without quiet batches (AlwaysOn
    switches no node) the two are equal."""
    r = _runs(name)
    n = int(r["legacy"].n_batches)
    assert r["legacy_syncs"] <= 2 * n + 1
    assert r["fused_syncs"] <= r["legacy_syncs"]
    if "AlwaysOn" in name:
        assert r["fused_syncs"] == r["legacy_syncs"]


def test_quiet_batches_are_off_under_the_legacy_loop():
    """The reference's ``test_quiet_gate_is_static``: opting out of the
    fused loop opts out of quiet batching too."""
    plat = tplat.PlatformSpec(nb_nodes=4)
    cfg = EngineConfig(timeout=60)
    assert engine._quiet_enabled(engine.make_const(plat, cfg, device=CPU), cfg)
    legacy = dataclasses.replace(cfg, fused_events=False)
    assert not engine._quiet_enabled(engine.make_const(plat, legacy, device=CPU), legacy)


@pytest.mark.parametrize("grouped", [False, True], ids=["ledger", "occ"])
def test_the_legacy_loop_launches_no_event_kernel(monkeypatch, grouped):
    """With the kernel route forced (``fused_kernel=True``: the wrappers'
    plain versions on the CPU) the fused loop calls the event kernel once a
    batch and the legacy loop never, with the same result."""
    calls = []
    for name in ("event_fuse_ledger", "event_fuse_occ"):
        real = getattr(event_fuse, name)
        monkeypatch.setattr(event_fuse, name,
                            lambda *a, _real=real, **k: calls.append(1) or _real(*a, **k))
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=30, nb_res=16, seed=1))
    cfg = EngineConfig(timeout=120, fused_kernel=True, grouped_tables=grouped)
    fused = engine.simulate(plat, wl, cfg, device=CPU)
    assert len(calls) == int(fused.n_batches)
    del calls[:]
    legacy = engine.simulate(plat, wl, dataclasses.replace(cfg, fused_events=False),
                             device=CPU)
    assert calls == [] and _differing_fields(legacy, fused) == []
    b = sweep.sweep(plat, wl, [60, 300], dataclasses.replace(cfg, fused_events=False),
                    device=CPU)
    assert calls == [] and int(b.state_at(0).n_batches) > 0


def test_gantt_runs_the_legacy_loop_shape():
    """``run_sim_gantt`` shares the legacy loop: its state is the legacy
    run's and its log has a row a batch after the first."""
    plat, wl, cfg = _runs("16 nodes EASY PSUS")["inputs"]
    cfg = engine.trim_window(cfg, len(wl))
    const = engine.make_const(plat, cfg, device=CPU)
    s0 = engine.init_state(plat, wl, cfg, device=CPU)
    s, log = engine.run_sim_gantt(s0, const, cfg, max_batches=10_000)
    assert _differing_fields(s, _runs("16 nodes EASY PSUS")["legacy"]) == []
    assert log.n == int(s.n_batches) - 1


# ------------------------------------------------------------------- sweep

@pytest.fixture(scope="module")
def sweeps():
    """``test_fused_bit_exact_traced_sweep``'s case: the six timeout
    schedulers at timeout 90 on 16 nodes, 50 jobs of seed 7."""
    twl, jwl = _generated(16, n_jobs=50, seed=7)
    tp, jp = tplat.PlatformSpec(nb_nodes=16), jplat.PlatformSpec(nb_nodes=16)
    cfg = EngineConfig(timeout=90)
    legacy = dataclasses.replace(cfg, fused_events=False)
    return dict(
        inputs=(tp, twl, legacy),
        legacy=sweep.sweep(tp, twl, SIX, legacy, device=CPU),
        fused=sweep.sweep(tp, twl, SIX, cfg, device=CPU),
        j_legacy=jeng.sweep(jp, jwl, SIX, JConfig(timeout=90, fused_events=False)),
    )


@pytest.mark.parametrize("row", range(len(SIX)))
def test_sweep_rows_under_the_legacy_loop(sweeps, row):
    tp, twl, legacy = sweeps["inputs"]
    got = sweeps["legacy"].state_at(row)
    assert _differing_fields(got, sweeps["fused"].state_at(row)) == []
    b, p = tpol.from_label(SIX[row])
    single = engine.simulate(tp, twl, dataclasses.replace(legacy, base=b, policy=p),
                             device=CPU)
    assert _differing_fields(got, single) == []
    jb = sweeps["j_legacy"]
    np.testing.assert_array_equal(metrics.schedule_table(got),
                                  jmet.schedule_table(jb.state_at(row)))
    assert int(got.n_batches) == int(jb.state_at(row).n_batches)
    assert sweeps["legacy"][row].total_energy_j == pytest.approx(
        jb[row].total_energy_j, rel=ENERGY_REL)
    m_o, des = run_pydes(tp, twl, dataclasses.replace(legacy, base=b, policy=p))
    np.testing.assert_array_equal(metrics.schedule_table(got), des.schedule_table())
    assert sweeps["legacy"][row].total_energy_j == pytest.approx(m_o.total_energy_j,
                                                                 rel=ENERGY_REL)


# -------------------------------------------------------------------- envs

def _env_configs(grouped, max_steps):
    tplat_, jplat_ = tplat.mixed_platform_example(16), jplat.mixed_platform_example(16)
    ekw = dict(rl_decision_interval=300, grouped_tables=grouped, fused_events=False)
    kw = dict(feature="compact_groups", action="group_target_fraction",
              reward="group_waste_wait", n_groups=3, n_action_levels=9,
              max_steps=max_steps)
    return (tplat_, jplat_,
            env.EnvConfig(engine=EngineConfig(policy=tpol.RLController(grouped=True), **ekw),
                          **kw),
            jenv.EnvConfig(engine=JConfig(policy=jpol.RLController(grouped=True), **ekw),
                           **kw))


def _assert_sims_close(got, want, what):
    for k, v in want.items():
        if k in ("energy", "energy_c", "wait_integral", "wait_c", "mode_energy"):
            continue
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (what, k)
    for k in ("energy", "wait_integral"):
        np.testing.assert_allclose(got[k], want[k], rtol=ENERGY_REL, atol=1e-3, err_msg=what)


def test_single_env_steps_match_the_reference_env():
    """Step by step against the reference's legacy env; the fused env of
    the port takes the same steps bit for bit."""
    tplat_, jplat_, tcfg, jcfg = _env_configs(False, max_steps=20)
    twl, jwl = _generated(16, n_jobs=20, seed=1)
    legacy = env.HPCGymEnv(tplat_, twl, tcfg, device=CPU)
    fused = env.HPCGymEnv(tplat_, twl, dataclasses.replace(
        tcfg, engine=dataclasses.replace(tcfg.engine, fused_events=True)), device=CPU)
    ref = jenv.HPCGymEnv(jplat_, jwl, jcfg)
    obs, obs_f, jobs = legacy.reset(), fused.reset(), ref.reset()
    assert torch.equal(obs, obs_f)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=OBS_ATOL, rtol=0)
    for k in range(20):
        a = (3 * k + 1) % tcfg.n_actions
        o, r, d, _ = legacy.step(a)
        of, rf, df, _ = fused.step(a)
        jo, jr, jd, _ = ref.step(a)
        assert torch.equal(o, of) and r == rf and d == df == jd, k
        assert _differing_fields(legacy.state.sim, fused.state.sim) == [], k
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=OBS_ATOL, rtol=0)
        _assert_sims_close(_np(legacy.state.sim), jmet.np_state(ref.state.sim), f"step {k}")
        np.testing.assert_array_equal(metrics.schedule_table(legacy.state.sim),
                                      jmet.schedule_table(ref.state.sim))
        if d:
            break


def test_batched_env_steps_match_single_envs_and_the_reference():
    """The ``[B]`` legacy step: each row == its own single legacy env bit
    for bit and == the reference's vmapped legacy ``batched_step`` (state
    to the tolerances above), one host read a step, no event kernel."""
    B = 2
    tplat_, jplat_, tcfg, jcfg = _env_configs(True, max_steps=12)
    tcfg = dataclasses.replace(tcfg, engine=engine.trim_window(tcfg.engine, 15))
    jcfg = dataclasses.replace(jcfg, engine=jeng.trim_window(jcfg.engine, 15))
    wls = [_generated(16, n_jobs=15, seed=s) for s in range(B)]
    tconst = engine.make_const(tplat_, tcfg.engine, device=CPU)
    jconst = jeng.make_const(jplat_, jcfg.engine, specialize=True)
    grid = env.make_env_grid(tconst, B)
    st, obs = env.batched_reset(tcfg, grid, a2c.make_batched_sims(
        tplat_, [w[0] for w in wls], tcfg, device=CPU))
    jst, _ = jax.jit(lambda s: jenv.batched_reset(jcfg, jconst, s))(
        ja2c.make_batched_sims(jplat_, [w[1] for w in wls], jcfg))
    singles = [env.HPCGymEnv(tplat_, w[0], tcfg, device=CPU) for w in wls]
    for b, e in enumerate(singles):
        assert torch.equal(obs[b], e.reset())
    jstep = jax.jit(lambda s, a: jenv.batched_step(jcfg, jconst, s, a))
    for k in range(12):
        acts = [(3 * k + b) % tcfg.n_actions for b in range(B)]
        engine.HOST_SYNCS = 0
        st, obs, r, d, _ = env.batched_step(tcfg, grid, st, torch.tensor(acts, dtype=torch.int32))
        assert engine.HOST_SYNCS == 1
        jst, jobs, _, jd, _ = jstep(jst, jnp.asarray(acts, jnp.int32))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=OBS_ATOL, rtol=0)
        for b, e in enumerate(singles):
            ob, rb, db, _ = e.step(acts[b])
            assert torch.equal(obs[b], ob) and float(r[b]) == rb and bool(d[b]) == db
            got = _np(engine.SimState(*[x[b] for x in st.sim]))
            assert all(np.array_equal(got[f], v) for f, v in _np(e.state.sim).items()), (k, b)
            _assert_sims_close(got, jmet.np_state(jeng.SimState(*[x[b] for x in jst.sim])),
                               f"step {k} row {b}")
        if bool(d.all()):
            break
