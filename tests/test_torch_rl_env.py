"""The PyTorch port's RL environment against the JAX reference's.

``env_reset`` / ``env_step`` (through ``HPCGymEnv``) run on fixed actions,
``(3k + 1) mod n_actions``, beside the reference's env on the same
platform and seeded workload: every translator, feature extractor and
reward appears in the cases, on the 16-node homogeneous, mixed and DVFS
platforms, dense and grouped. At every step:

- the integer state, the schedule table and ``done`` are bit for bit the
  reference's;
- energy and the waiting integral agree to rel 1e-5 (the DVFS mode energy
  to 1e-4 on the dense route, ROADMAP Queue 3 item 4);
- observations agree to ``OBS_ATOL`` (they are sums and logs of f32 values
  in [0, 1]; the port sums the nodes in f64 and rounds once);
- rewards agree to ``REWARD_REL`` of the normalised cumulative energy and
  wait that the reward is a difference of (an f32 difference of cumulative
  values carries their error, not the delta's).

The ``[B]`` batched step equals B single envs bit for bit and the
reference's vmapped ``batched_step`` to the same tolerances; it reads the
device once a step. An episode runs to done, and a step after done changes
nothing. The validation messages are the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.metrics import np_state as j_np_state
from repro.core.metrics import schedule_table as j_schedule_table
from repro.core.policy import RLController as JRL
from repro.core.rl import a2c as ja2c
from repro.core.rl import env as jenv
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import engine, metrics
from repro_torch.core.policy import RLController
from repro_torch.core.rl import a2c, env
from repro_torch.core.types import EngineConfig
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

CPU = "cpu"
OBS_ATOL = 1e-6
REWARD_REL = 1e-5
STEPS = 40
PLATFORMS = {
    "homogeneous": (lambda: tplat.PlatformSpec(nb_nodes=16, t_switch_on=120,
                                               t_switch_off=180),
                    lambda: jplat.PlatformSpec(nb_nodes=16, t_switch_on=120,
                                               t_switch_off=180)),
    "mixed": (lambda: tplat.mixed_platform_example(16),
              lambda: jplat.mixed_platform_example(16)),
    "dvfs": (lambda: tplat.dvfs_platform_example(16),
             lambda: jplat.dvfs_platform_example(16)),
}
# float fields compared by tolerance; every other field bit for bit
FLOAT_FIELDS = ("energy", "energy_c", "wait_integral", "wait_c", "mode_energy")

# (platform, action, feature, reward, grouped tables)
CASES = [
    ("homogeneous", "target_fraction", "compact", "waste_wait", False),
    ("homogeneous", "delta", "queue_window", "energy_wait", False),
    ("homogeneous", "target_fraction", "compact_forecast", "wait_only", False),
    ("homogeneous", "delta", "compact", "energy_only", True),
    ("mixed", "group_target_fraction", "compact_groups", "group_waste_wait", False),
    ("mixed", "group_target_fraction", "compact_groups", "group_waste_wait", True),
    ("mixed", "target_fraction", "queue_window", "waste_wait", False),
    ("mixed", "group_target_fraction", "compact_dvfs", "energy_wait", False),
    ("dvfs", "group_mode", "compact_dvfs", "energy_wait", False),
    ("dvfs", "group_mode", "compact_dvfs", "energy_only", True),
    ("dvfs", "target_fraction", "compact_groups", "group_waste_wait", False),
    ("dvfs", "group_mode", "compact", "wait_only", False),
]


def _levels(action, plat):
    if action == "group_mode":
        return plat.n_dvfs_modes()
    return 5 if action == "delta" else 9


def _configs(plat_name, action, feature, reward, grouped, max_steps=STEPS, **ekw):
    tplat_, jplat_ = (f() for f in PLATFORMS[plat_name])
    pol = dict(grouped=action == "group_target_fraction", dvfs=action == "group_mode")
    ekw = dict(rl_decision_interval=300, grouped_tables=grouped, **ekw)
    kw = dict(feature=feature, action=action, reward=reward, n_groups=tplat_.n_groups(),
              n_action_levels=_levels(action, tplat_), max_steps=max_steps)
    return (tplat_, jplat_,
            env.EnvConfig(engine=EngineConfig(policy=RLController(**pol), **ekw), **kw),
            jenv.EnvConfig(engine=JConfig(policy=JRL(**pol), **ekw), **kw))


def _workloads(seed, n_jobs=20):
    cfg = dict(n_jobs=n_jobs, nb_res=16, seed=seed)
    return (tgen.generate_workload(tgen.GeneratorConfig(**cfg)),
            jgen.generate_workload(jgen.GeneratorConfig(**cfg)))


def _reward_tol(sim_np, const):
    """REWARD_REL of the normalised cumulative energy and wait (the energy
    over the smallest group's active draw bounds every reward's scale)."""
    gw = np.bincount(np.asarray(const.group_id), weights=np.asarray(const.power)[:, 3])
    e_norm = float(np.sum(sim_np["energy"])) / (float(gw[gw > 0].min()) * 3600.0)
    w_norm = float(sim_np["wait_integral"]) / (16 * 3600.0)
    return REWARD_REL * (abs(e_norm) + abs(w_norm)) + 1e-9


def _assert_sims_close(got, want, dense_dvfs, what):
    for k, v in want.items():
        if k in FLOAT_FIELDS:
            continue
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (what, k)
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-5, atol=1e-3,
                               err_msg=what)
    np.testing.assert_allclose(got["wait_integral"], want["wait_integral"], rtol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(got["mode_energy"], want["mode_energy"],
                               rtol=1e-4 if dense_dvfs else 1e-5, atol=1e-3, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_env_steps_match_the_reference(case):
    plat_name, action, feature, reward, grouped = case
    tplat_, jplat_, tcfg, jcfg = _configs(*case)
    twl, jwl = _workloads(seed=CASES.index(case))
    tenv_ = env.HPCGymEnv(tplat_, twl, tcfg, device=CPU)
    jenv_ = jenv.HPCGymEnv(jplat_, jwl, jcfg)
    np.testing.assert_allclose(tenv_.reset().numpy(), np.asarray(jenv_.reset()),
                               atol=OBS_ATOL, rtol=0)
    dense_dvfs = plat_name == "dvfs" and not grouped
    for k in range(STEPS):
        a = (3 * k + 1) % tcfg.n_actions
        tobs, tr, td, tinfo = tenv_.step(a)
        jobs, jr, jd, jinfo = jenv_.step(a)
        what = f"step {k}"
        assert td == jd, what
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=OBS_ATOL, rtol=0,
                                   err_msg=what)
        got, want = metrics.np_state(tenv_.state.sim), j_np_state(jenv_.state.sim)
        assert abs(tr - jr) <= _reward_tol(want, jenv_.const), (what, tr, jr)
        _assert_sims_close(got, want, dense_dvfs, what)
        np.testing.assert_array_equal(metrics.schedule_table(tenv_.state.sim),
                                      j_schedule_table(jenv_.state.sim))
        assert int(tenv_.state.steps) == int(jenv_.state.steps)
        if td:
            break


@pytest.mark.parametrize("case", [CASES[0], CASES[5], CASES[9]],
                         ids=["homogeneous", "mixed-grouped", "dvfs-grouped"])
def test_batched_step_equals_single_envs_and_the_reference(case):
    """The [B] step: each row == its own single env bit for bit (state,
    observation, reward, done), == the reference's vmapped batched_step to
    the tolerances above, one host read a step."""
    B = 4
    tplat_, jplat_, tcfg, jcfg = _configs(*case, max_steps=30)
    tcfg = dataclasses.replace(tcfg, engine=engine.trim_window(tcfg.engine, 15))
    jcfg = dataclasses.replace(jcfg, engine=jeng.trim_window(jcfg.engine, 15))
    wls = [_workloads(seed=s, n_jobs=15) for s in range(B)]
    tconst = engine.make_const(tplat_, tcfg.engine, device=CPU)
    jconst = jeng.make_const(jplat_, jcfg.engine, specialize=True)
    sims0 = a2c.make_batched_sims(tplat_, [w[0] for w in wls], tcfg, device=CPU)
    jsims0 = ja2c.make_batched_sims(jplat_, [w[1] for w in wls], jcfg)
    grid = env.make_env_grid(tconst, B)
    st, obs = env.batched_reset(tcfg, grid, sims0)
    jst, jobs = jenv.batched_reset(jcfg, jconst, jsims0)
    singles = [env.HPCGymEnv(tplat_, w[0], tcfg, device=CPU) for w in wls]
    for b, e in enumerate(singles):
        assert torch.equal(obs[b], e.reset())
    jstep = jax.jit(lambda s, a: jenv.batched_step(jcfg, jconst, s, a))
    dense_dvfs = case[0] == "dvfs" and not case[4]
    for k in range(40):
        acts = [(3 * k + b) % tcfg.n_actions for b in range(B)]
        engine.HOST_SYNCS = 0
        st, obs, r, d, _ = env.batched_step(tcfg, grid, st,
                                            torch.tensor(acts, dtype=torch.int32))
        assert engine.HOST_SYNCS == 1
        jst, jobs, jr, jd, _ = jstep(jst, jnp.asarray(acts, jnp.int32))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=OBS_ATOL, rtol=0)
        for b, e in enumerate(singles):
            ob, rb, db, _ = e.step(acts[b])
            assert torch.equal(obs[b], ob) and float(r[b]) == rb and bool(d[b]) == db
            got = metrics.np_state(engine.SimState(*[x[b] for x in st.sim]))
            mine = metrics.np_state(e.state.sim)
            assert all(np.array_equal(got[f], mine[f]) for f in got), (k, b)
            want = j_np_state(jeng.SimState(*[x[b] for x in jst.sim]))
            _assert_sims_close(got, want, dense_dvfs, f"step {k} row {b}")
            assert abs(float(r[b]) - float(jr[b])) <= _reward_tol(want, jconst)
        if bool(d.all()):
            break
    assert bool(d.all())


def test_episode_runs_to_done_and_a_step_after_done_is_a_noop():
    tplat_, _, tcfg, _ = _configs("homogeneous", "target_fraction", "compact",
                                  "waste_wait", False, max_steps=500)
    twl, _ = _workloads(seed=1, n_jobs=3)
    e = env.HPCGymEnv(tplat_, twl, tcfg, device=CPU)
    e.reset()
    done, steps = False, 0
    while not done and steps < 300:
        _, r, done, _ = e.step(0)
        steps += 1
    assert done
    d = metrics.np_state(e.state.sim)
    assert (d["job_status"][d["job_exists"]] == 3).all()
    before = metrics.np_state(e.state.sim)
    n = int(e.state.steps)
    _, r, done, info = e.step(4)
    after = metrics.np_state(e.state.sim)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert r == 0.0 and done and int(e.state.steps) == n
    assert float(info["energy_j"]) == float(np.sum(before["energy"], dtype=np.float32))


def _message(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize("kw", [
    dict(engine=dict(policy="psus")),
    dict(engine=dict(policy="controller")),
    dict(action="group_target_fraction"),
    dict(action="group_mode", n_action_levels=3),
    dict(engine=dict(policy="grouped")),
])
def test_env_config_messages_are_the_reference(kw):
    from repro.core.policy import TimeoutSleep as JTS
    from repro_torch.core.policy import TimeoutSleep

    def make(EnvConfig, Config, RL, TS):
        pol = {"psus": TS(), "controller": RL(controller=lambda s, c: None),
               "grouped": RL(grouped=True)}.get(kw.get("engine", {}).get("policy"), RL())
        rest = {k: v for k, v in kw.items() if k != "engine"}
        return EnvConfig(engine=Config(policy=pol), **rest)

    assert _message(lambda: make(env.EnvConfig, EngineConfig, RLController, TimeoutSleep)) \
        == _message(lambda: make(jenv.EnvConfig, JConfig, JRL, JTS))


@pytest.mark.parametrize("kw", [dict(n_groups=2), dict(n_action_levels=4)])
def test_gym_env_messages_are_the_reference(kw):
    tplat_, jplat_, tcfg, jcfg = _configs("dvfs", "group_mode", "compact_dvfs",
                                          "energy_wait", False)
    twl, jwl = _workloads(seed=0)
    assert _message(lambda: env.HPCGymEnv(tplat_, twl, dataclasses.replace(tcfg, **kw),
                                          device=CPU)) \
        == _message(lambda: jenv.HPCGymEnv(jplat_, jwl, dataclasses.replace(jcfg, **kw)))
