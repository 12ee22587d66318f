"""The port's single run ignores ``EngineConfig.devices``, as the reference's
``simulate`` does (the field only places a sweep's scenario axis).

Each case runs ``simulate(..., device="cpu")`` beside
``repro.core.engine.simulate`` on the same 8-node, 5-job inputs with a
``devices`` value set: the schedule table, the clock and the batch count are
the reference's exactly, energy agrees to rel 1e-5 (f32 ledgers summed in
another order), and the port's run equals its own run with ``devices=None``
bit for bit. The single ``HPCGymEnv`` takes ``devices=1`` through a reset and
a few steps. The sweep and the batched env still refuse more than one device
(``tests/test_torch_sweep.py``, ``tests/test_torch_rl_env.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import metrics as jmet
from repro.core import policy as jpol
from repro.core.policy import RLController as JRL
from repro.core.rl import env as jenv
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import engine as teng
from repro_torch.core import metrics as tmet
from repro_torch.core import policy as tpol
from repro_torch.core.policy import RLController
from repro_torch.core.rl import env as tenv
from repro_torch.core.types import EngineConfig as TConfig
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

ENERGY_REL = 1e-5

CASES = [
    ("EASY RL:groups", {"grouped_tables": True, "devices": 2}),
    ("FCFS PSAS+IPM+Forecast", {"node_order": "pack", "devices": "all"}),
    ("EASY PSUS", {"devices": 1}),
    ("EASY PSUS", {"devices": 2}),
    ("EASY RL", {"devices": 1}),
    ("EASY PSUS+Forecast", {"devices": 4}),
    ("EASY PSUS", {"devices": None}),
    ("EASY PSUS", {"devices": "all"}),
]


@pytest.mark.parametrize("label,kw", CASES, ids=[f"{c[0]}-{c[1]['devices']}" for c in CASES])
def test_single_run_with_devices_equals_the_reference(label, kw):
    jb, jp = jpol.from_label(label)
    tb, tp = tpol.from_label(label)
    jc, tc = JConfig(base=jb, policy=jp, **kw), TConfig(base=tb, policy=tp, **kw)
    jplat_, tplat_ = jplat.PlatformSpec(nb_nodes=8), tplat.PlatformSpec(nb_nodes=8)
    jw = jgen.generate_workload(jgen.GeneratorConfig(n_jobs=5, nb_res=8))
    tw = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=5, nb_res=8))

    got = teng.simulate(tplat_, tw, tc, device="cpu")
    want = jeng.simulate(jplat_, jw, jc)
    np.testing.assert_array_equal(tmet.schedule_table(got), jmet.schedule_table(want))
    for fld in ("t", "n_batches", "n_switch_on", "n_switch_off", "truncated"):
        np.testing.assert_array_equal(getattr(got, fld).numpy(),
                                      np.asarray(getattr(want, fld)), err_msg=fld)
    mt = tmet.metrics_from_state(got, tplat_)
    mj = jmet.metrics_from_state(want, jplat_)
    assert mt.total_energy_j == pytest.approx(mj.total_energy_j, rel=ENERGY_REL)
    assert mt.wasted_energy_j == pytest.approx(mj.wasted_energy_j, rel=ENERGY_REL)

    plain = teng.simulate(tplat_, tw, dataclasses.replace(tc, devices=None), device="cpu")
    a, b = tmet.np_state(got), tmet.np_state(plain)
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []


def test_single_gym_env_takes_one_device():
    """``HPCGymEnv`` with ``devices=1``: reset and 6 steps equal the same env
    without ``devices`` bit for bit and the reference's env with it (schedule
    exact, observations to 1e-6)."""
    kw = dict(feature="compact", action="target_fraction", reward="waste_wait",
              n_groups=1, n_action_levels=9, max_steps=10)
    ekw = dict(rl_decision_interval=300, devices=1)
    tcfg = tenv.EnvConfig(engine=TConfig(policy=RLController(), **ekw), **kw)
    jcfg = jenv.EnvConfig(engine=JConfig(policy=JRL(), **ekw), **kw)
    gen = dict(n_jobs=12, nb_res=16, seed=3)
    tplat_ = tplat.PlatformSpec(nb_nodes=16, t_switch_on=120, t_switch_off=180)
    jplat_ = jplat.PlatformSpec(nb_nodes=16, t_switch_on=120, t_switch_off=180)
    twl = tgen.generate_workload(tgen.GeneratorConfig(**gen))
    jwl = jgen.generate_workload(jgen.GeneratorConfig(**gen))

    env1 = tenv.HPCGymEnv(tplat_, twl, tcfg, device="cpu")
    env0 = tenv.HPCGymEnv(tplat_, twl, dataclasses.replace(
        tcfg, engine=dataclasses.replace(tcfg.engine, devices=None)), device="cpu")
    ref = jenv.HPCGymEnv(jplat_, jwl, jcfg)
    obs1 = env1.reset()
    assert torch.equal(obs1, env0.reset())
    np.testing.assert_allclose(obs1.numpy(), np.asarray(ref.reset()), atol=1e-6, rtol=0)
    for k in range(6):
        a = (3 * k + 1) % tcfg.n_actions
        o1, r1, d1, _ = env1.step(a)
        o0, r0, d0, _ = env0.step(a)
        oj, _, dj, _ = ref.step(a)
        assert torch.equal(o1, o0) and r1 == r0 and d1 == d0, k
        assert d1 == dj, k
        np.testing.assert_allclose(o1.numpy(), np.asarray(oj), atol=1e-6, rtol=0)
        a1, a0 = tmet.np_state(env1.state.sim), tmet.np_state(env0.state.sim)
        assert [f for f in a1 if not np.array_equal(a1[f], a0[f])] == [], k
        np.testing.assert_array_equal(tmet.schedule_table(env1.state.sim),
                                      jmet.schedule_table(ref.state.sim))
        if d1:
            break
