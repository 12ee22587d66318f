"""The batched RL env under the engine options a single env runs:
``allocation="partition"``, ``node_order="pack"`` and ``merge_bursts``.

``batched_step`` steps its ``[B]`` rows on the sweep's batch functions, so
each row must equal its own ``HPCGymEnv`` (the single run's
``engine.process_batch``) bit for bit — state, observation, reward, done —
under every option, and the JAX reference's vmapped ``batched_step`` to
``test_torch_rl_env.py``'s tolerances. The setup is that file's batched
test on the 16-node mixed platform (B = 4, 15 jobs, EASY RL:groups on
grouped tables, the window trimmed to 15), and for burst merging a burst of
narrow jobs (1 s mean inter-arrival, at most 2 nodes a job) behind a
window of 2. Then an A2C rollout under partition, each row replayed
through its own single env, and the guard: a batched env on a config the
sweep refuses raises at reset, naming its ROADMAP item.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.metrics import np_state as j_np_state
from repro.core.rl import a2c as ja2c
from repro.core.rl import env as jenv
from repro.workloads import generator as jgen
from repro_torch.core import engine, metrics
from repro_torch.core.rl import a2c, env
from repro_torch.core.rl.networks import policy_init
from repro_torch.workloads import generator as tgen

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_rl_env import (  # noqa: E402
    CASES,
    OBS_ATOL,
    _assert_sims_close,
    _configs,
    _reward_tol,
)

CPU = "cpu"
B = 4
CASE = CASES[5]  # mixed platform, group_target_fraction, grouped tables
# option -> (engine options, generator settings beyond n_jobs/nb_res/seed)
OPTIONS = {
    "partition": (dict(allocation="partition"), {}),
    "pack": (dict(node_order="pack"), {}),
    "merge_bursts": (dict(merge_bursts=True, window=2),
                     dict(mean_interarrival=1.0, max_res=2)),
}


def _setup(option, max_steps=30, case=CASE):
    ekw, gen = OPTIONS[option]
    tplat_, jplat_, tcfg, jcfg = _configs(*case, max_steps=max_steps, **ekw)
    tcfg = dataclasses.replace(tcfg, engine=engine.trim_window(tcfg.engine, 15))
    jcfg = dataclasses.replace(jcfg, engine=jeng.trim_window(jcfg.engine, 15))
    gcfgs = [dict(n_jobs=15, nb_res=16, seed=s, **gen) for s in range(B)]
    twls = [tgen.generate_workload(tgen.GeneratorConfig(**g)) for g in gcfgs]
    jwls = [jgen.generate_workload(jgen.GeneratorConfig(**g)) for g in gcfgs]
    return tplat_, jplat_, tcfg, jcfg, twls, jwls


def _row_state(sim, b):
    return metrics.np_state(engine.SimState(*[x[b] for x in sim]))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_batched_rows_are_their_single_envs_and_the_reference(option):
    """Every step of every row == its own HPCGymEnv bit for bit and == the
    JAX batched_step to the tolerances of test_torch_rl_env.py. On the
    parent of this change the batched rows ignored the option and differed
    from their single envs at the first step."""
    tplat_, jplat_, tcfg, jcfg, twls, jwls = _setup(option)
    tconst = engine.make_const(tplat_, tcfg.engine, device=CPU)
    jconst = jeng.make_const(jplat_, jcfg.engine, specialize=True)
    sims0 = a2c.make_batched_sims(tplat_, twls, tcfg, device=CPU)
    jsims0 = ja2c.make_batched_sims(jplat_, jwls, jcfg)
    grid = env.make_env_grid(tconst, B)
    st, obs = env.batched_reset(tcfg, grid, sims0)
    jst, jobs = jenv.batched_reset(jcfg, jconst, jsims0)
    singles = [env.HPCGymEnv(tplat_, w, tcfg, device=CPU) for w in twls]
    for b, e in enumerate(singles):
        assert torch.equal(obs[b], e.reset())
        assert all(np.array_equal(v, metrics.np_state(e.state.sim)[k])
                   for k, v in _row_state(st.sim, b).items()), ("reset", b)
    jstep = jax.jit(lambda s, a: jenv.batched_step(jcfg, jconst, s, a))
    for k in range(30):
        acts = [(3 * k + b) % tcfg.n_actions for b in range(B)]
        st, obs, r, d, _ = env.batched_step(tcfg, grid, st,
                                            torch.tensor(acts, dtype=torch.int32))
        jst, jobs, jr, jd, _ = jstep(jst, jnp.asarray(acts, jnp.int32))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=OBS_ATOL, rtol=0)
        for b, e in enumerate(singles):
            ob, rb, db, _ = e.step(acts[b])
            what = f"{option} step {k} row {b}"
            assert torch.equal(obs[b], ob) and float(r[b]) == rb and bool(d[b]) == db, what
            got, mine = _row_state(st.sim, b), metrics.np_state(e.state.sim)
            bad = [f for f in got if not np.array_equal(got[f], mine[f])]
            assert not bad, (what, bad)
            want = j_np_state(jeng.SimState(*[x[b] for x in jst.sim]))
            _assert_sims_close(got, want, False, what)
            assert abs(float(r[b]) - float(jr[b])) <= _reward_tol(want, jconst), what
        if bool(d.all()):
            break


def test_an_a2c_rollout_under_partition_is_its_single_envs():
    """A2C's rollout (sampled actions, auto-reset) on partition rows: each
    row, replayed action by action through its own HPCGymEnv with the same
    resets, gives the rollout's observations, rewards and dones bit for
    bit."""
    tplat_, _, tcfg, _, twls, _ = _setup("partition", max_steps=6)
    tconst = engine.make_const(tplat_, tcfg.engine, device=CPU)
    sims0 = a2c.make_batched_sims(tplat_, twls, tcfg, device=CPU)
    model = policy_init(torch.Generator().manual_seed(3), tcfg.obs_size, tcfg.n_actions)
    grid, fresh = a2c._grid_and_reset(tcfg, tconst, sims0)
    T = 16
    _, _, roll = a2c.collect_rollout(model, fresh[0], fresh[1],
                                     torch.Generator().manual_seed(7), fresh, tcfg, grid, T)
    assert roll.dones.any()  # episodes ended inside the rollout and were reset
    for b, w in enumerate(twls):
        e = env.HPCGymEnv(tplat_, w, tcfg, device=CPU)
        ob, done = e.reset(), False
        for t in range(T):
            if done:
                ob = e.reset()
            assert torch.equal(roll.obs[t, b], ob), (t, b)
            ob, rb, done, _ = e.step(int(roll.actions[t, b]))
            assert float(roll.rewards[t, b]) == rb and bool(roll.dones[t, b]) == done, (t, b)
