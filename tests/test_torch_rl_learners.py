"""The PyTorch port's RL networks, optimizer and learners against the JAX
reference's.

- A policy carried across (``convert.policy_params_from_arrays`` /
  ``policy_params_to_arrays``) gives the reference's logits and values to
  rtol 1e-5 (atol 1e-6 of the largest magnitude, for outputs that cancel
  to near zero; random non-zero heads from a fixed seed).
- On one rollout of the port (4 envs, 8 steps, actions sampled on the
  device), replayed through the JAX env with the port's actions (the same
  dones and live masks; observations and rewards to the env tests'
  tolerances): ``gae`` equals the reference's, and ``a2c_loss`` and
  ``ppo_loss`` with their autograd gradients equal ``jax.value_and_grad``
  of the reference's losses to rtol 1e-5 (atol 1e-6 of each leaf's largest
  gradient, for entries that cancel to near zero).
- One ``adamw`` step and ``clip_by_global_norm`` equal the reference's.
- ``train_a2c``, ``train_ppo`` and ``train_a2c_curriculum`` at
  ``tests/test_rl.py``'s sizes give finite losses and move the parameters.
- The RL modules import neither jax nor ``repro`` (a subprocess).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.policy import RLController as JRL
from repro.core.rl import a2c as ja2c
from repro.core.rl import env as jenv
from repro.core.rl import networks as jnet
from repro.core.rl import ppo as jppo
from repro.core.types import EngineConfig as JConfig
from repro.training import optimizer as jopt
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import convert, engine
from repro_torch.core.policy import RLController
from repro_torch.core.rl import a2c, curriculum, env, networks, ppo
from repro_torch.core.types import EngineConfig
from repro_torch.training import optimizer as topt
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
RTOL = 1e-5
B, T = 4, 8


def _jax_params(seed, obs_size, n_actions, hidden=(128, 128)):
    """The reference's policy with random non-zero heads (so logits do not
    tie), as numpy arrays."""
    p = jnet.policy_init(jax.random.PRNGKey(seed), obs_size, n_actions, hidden)
    rng = np.random.default_rng(seed)
    for head in ("pi", "v"):
        w = p[head][-1]["w"]
        p[head][-1]["w"] = jnp.asarray(rng.normal(0, 0.3, w.shape).astype(np.float32))
    return jax.tree_util.tree_map(np.asarray, p)


def _leaves(tree):
    """Leaves in the reference's pytree order, as numpy arrays."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_grads_as_tree(model, grads):
    """The port's per-parameter gradients in the reference's tree."""
    named = dict(zip([n for n, _ in model.named_parameters()], grads))
    out = {}
    for head in ("torso", "pi", "v"):
        layers = getattr(model, head)
        out[head] = [{"w": named[f"{head}.{i}.weight"].detach().numpy().T,
                      "b": named[f"{head}.{i}.bias"].detach().numpy()}
                     for i in range(len(layers))]
    return out


def _assert_tree_close(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6 * scale + 1e-12)


@pytest.mark.parametrize("hidden", [(128, 128), (32,)])
def test_networks_carried_across_give_the_same_logits_and_values(hidden):
    p = _jax_params(3, 26, 27, hidden)
    model = convert.policy_params_from_arrays(p, device=CPU)
    obs = np.random.default_rng(0).random((64, 26), dtype=np.float32)
    jl, jv = jax.vmap(jnet.policy_apply, (None, 0))(p, obs)
    tl, tv = model(torch.from_numpy(obs))
    # atol: entries that cancel to near zero carry the rounding of the largest
    for got, want in ((tl, jl), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                                   atol=1e-6 * float(np.abs(want).max()))
    back = convert.policy_params_to_arrays(model)
    for g, w in zip(_leaves(back), _leaves(p)):
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_policy_init_is_seeded_and_zero_headed():
    a = networks.policy_init(torch.Generator().manual_seed(5), 20, 9)
    b = networks.policy_init(torch.Generator().manual_seed(5), 20, 9)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert not a.pi[0].weight.any() and not a.v[0].weight.any()
    logits, value = networks.policy_apply(a, torch.rand(3, 20))
    assert torch.equal(logits, torch.zeros(3, 9)) and torch.equal(value, torch.zeros(3))
    # He-normal torso: std sqrt(2 / fan_in)
    assert abs(float(a.torso[0].weight.detach().std()) - (2.0 / 20) ** 0.5) < 0.03


# --------------------------------------------------------------------------
# one rollout, replayed through the reference
# --------------------------------------------------------------------------

def _env_cfgs():
    ekw = dict(rl_decision_interval=300)
    kw = dict(max_steps=6)  # episodes end inside the rollout: auto-reset runs
    return (env.EnvConfig(engine=EngineConfig(policy=RLController(), **ekw), **kw),
            jenv.EnvConfig(engine=JConfig(policy=JRL(), **ekw), **kw))


@pytest.fixture(scope="module")
def rollout():
    tcfg, jcfg = _env_cfgs()
    tp = tplat.PlatformSpec(nb_nodes=16, t_switch_on=120, t_switch_off=180)
    jp = jplat.PlatformSpec(nb_nodes=16, t_switch_on=120, t_switch_off=180)
    gcfgs = [dict(n_jobs=16, nb_res=16, seed=s) for s in range(B)]
    twls = [tgen.generate_workload(tgen.GeneratorConfig(**g)) for g in gcfgs]
    jwls = [jgen.generate_workload(jgen.GeneratorConfig(**g)) for g in gcfgs]
    tconst = engine.make_const(tp, tcfg.engine, device=CPU)
    jconst = jeng.make_const(jp, jcfg.engine, specialize=True)
    sims0 = a2c.make_batched_sims(tp, twls, tcfg, device=CPU)
    jsims0 = ja2c.make_batched_sims(jp, jwls, jcfg)
    p = _jax_params(1, tcfg.obs_size, tcfg.n_actions)
    model = convert.policy_params_from_arrays(p, device=CPU)
    grid, fresh = a2c._grid_and_reset(tcfg, tconst, sims0)
    gen = torch.Generator().manual_seed(7)
    _, _, roll = a2c.collect_rollout(model, fresh[0], fresh[1], gen, fresh, tcfg, grid, T)
    # replay the port's actions through the reference env, with its auto-reset
    reset = jax.vmap(functools.partial(jenv.env_reset, jcfg, jconst))
    step = jax.jit(jax.vmap(functools.partial(jenv.env_step, jcfg, jconst)))
    fresh_j, fresh_obs = reset(jsims0)
    st, obs = fresh_j, fresh_obs
    j_obs, j_rew, j_done, j_live = [], [], [], []
    for t in range(T):
        need = st.done
        st = jax.tree_util.tree_map(
            lambda f, c: jnp.where(need.reshape((-1,) + (1,) * (c.ndim - 1)), f, c),
            fresh_j, st)
        obs = jnp.where(need[:, None], fresh_obs, obs)
        j_obs.append(obs)
        j_live.append(~st.done)
        st, obs, r, d, _ = step(st, jnp.asarray(roll.actions[t].numpy(), jnp.int32))
        j_rew.append(r)
        j_done.append(d)
    return dict(model=model, params=p, roll=roll, tcfg=tcfg,
                replay=[np.stack([np.asarray(x) for x in xs])
                        for xs in (j_obs, j_rew, j_done, j_live)])


def _roll_np(roll):
    return ja2c.Rollout(*[jnp.asarray(x.numpy()) for x in roll])


def test_rollout_replays_through_the_reference_env(rollout):
    roll = rollout["roll"]
    obs, rew, done, live = rollout["replay"]
    assert roll.dones.any()  # episodes ended inside the rollout and were reset
    np.testing.assert_array_equal(roll.dones.numpy(), done)
    np.testing.assert_array_equal(roll.live.numpy(), live)
    np.testing.assert_allclose(roll.obs.numpy(), obs, atol=1e-6, rtol=0)
    np.testing.assert_allclose(roll.rewards.numpy(), rew, atol=1e-6, rtol=1e-5)


def test_gae_matches_the_reference(rollout):
    roll = rollout["roll"]
    advs, rets = a2c.gae(roll, 0.99, 0.95)
    jadvs, jrets = ja2c.gae(_roll_np(roll), 0.99, 0.95)
    np.testing.assert_allclose(advs.numpy(), np.asarray(jadvs), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(rets.numpy(), np.asarray(jrets), rtol=RTOL, atol=1e-7)


def test_a2c_loss_and_gradients_match_the_reference(rollout):
    roll, model, p = rollout["roll"], rollout["model"], rollout["params"]
    cfg = a2c.A2CConfig()
    advs, rets = a2c.gae(roll, cfg.gamma, cfg.gae_lambda)
    loss, aux = a2c.a2c_loss(model, roll, advs, rets, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jcfg = ja2c.A2CConfig()
    (jloss, jaux), jgrads = jax.value_and_grad(ja2c.a2c_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), _roll_np(roll),
        jnp.asarray(advs.numpy()), jnp.asarray(rets.numpy()), jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for k in ("pg_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=RTOL, atol=1e-7)
    _assert_tree_close(_port_grads_as_tree(model, grads), jgrads)


def test_ppo_loss_and_gradients_match_the_reference(rollout):
    roll, model, p = rollout["roll"], rollout["model"], rollout["params"]
    cfg = ppo.PPOConfig()
    advs, rets = a2c.gae(roll, cfg.gamma, cfg.gae_lambda)
    rng = np.random.default_rng(3)
    # an old policy a little off the current one, so the ratio clips
    old_logp = torch.log_softmax(model(roll.obs)[0], -1).gather(
        -1, roll.actions[..., None])[..., 0].detach()
    old_logp = old_logp + torch.from_numpy(rng.normal(0, 0.3, old_logp.shape).astype(np.float32))
    batch = tuple(x.flatten(0, 1) for x in (roll.obs, roll.actions, old_logp, advs, rets,
                                            roll.live.float()))
    loss, aux = ppo.ppo_loss(model, batch, cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    (jloss, jaux), jgrads = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p),
        tuple(jnp.asarray(x.numpy()) for x in batch), jppo.PPOConfig())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    for k in ("pg_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=RTOL, atol=1e-7)
    _assert_tree_close(_port_grads_as_tree(model, grads), jgrads)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_and_clip_match_the_reference(wd):
    p = _jax_params(4, 20, 9)
    rng = np.random.default_rng(4)
    g = jax.tree_util.tree_map(
        lambda x: rng.normal(0, 2.0, x.shape).astype(np.float32), p)
    model = convert.policy_params_from_arrays(p, device=CPU)
    tg = [torch.from_numpy(np.ascontiguousarray(x)) for x in _port_leaves(model, g)]
    clipped, norm = topt.clip_by_global_norm(tg, 0.5)
    jclipped, jnorm = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), 0.5)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    opt, jo = topt.adamw(lr=1e-3, weight_decay=wd), jopt.adamw(lr=1e-3, weight_decay=wd)
    params = list(model.parameters())
    state = opt.init(params)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jstate = jo.init(jp)
    for _ in range(2):
        upd, state = opt.update(clipped, state, params)
        topt.apply_updates(params, upd)
        jupd, jstate = jo.update(jclipped, jstate, jp)
        jp = jopt.apply_updates(jp, jupd)
    assert int(state.step) == int(jstate.step) == 2
    _assert_tree_close(convert.policy_params_to_arrays(model), jp)


def _port_leaves(model, tree):
    """``tree`` (the reference's layout) in the port's parameter order,
    weights as ``[out, in]``."""
    out = []
    for name, _ in model.named_parameters():
        head, i, kind = name.split(".")
        x = np.asarray(tree[head][int(i)]["w" if kind == "weight" else "b"])
        out.append(x.T if kind == "weight" else x)
    return out


# --------------------------------------------------------------------------
# the learners at tests/test_rl.py's sizes
# --------------------------------------------------------------------------

PLAT = tplat.PlatformSpec(nb_nodes=16, t_switch_on=120, t_switch_off=180)


def _cfg(**kw):
    return env.EnvConfig(
        engine=EngineConfig(policy=RLController(), rl_decision_interval=300), **kw)


def _moved(before, model):
    return sum(float((a - b).abs().sum()) for a, b in zip(before, model.parameters()))


def test_a2c_updates_are_finite_and_move_the_parameters():
    wls = [tgen.generate_workload(tgen.GeneratorConfig(n_jobs=16, nb_res=16, seed=s))
           for s in range(4)]
    cfg = _cfg(max_steps=64)
    acfg = a2c.A2CConfig(n_envs=4, n_steps=8, lr=1e-3, n_updates=3)
    params, history = a2c.train_a2c(PLAT, wls, cfg, acfg, device=CPU)
    assert len(history) == 3
    assert all(np.isfinite(h["loss"]) and h["entropy"] > 0 for h in history)
    init = networks.policy_init(torch.Generator().manual_seed(acfg.seed), cfg.obs_size,
                                cfg.n_actions)
    assert _moved(list(init.parameters()), params) > 0


def test_ppo_update_is_finite_and_moves_the_parameters():
    wls = [tgen.generate_workload(tgen.GeneratorConfig(n_jobs=12, nb_res=16, seed=s))
           for s in range(4)]
    cfg = _cfg(max_steps=48)
    pcfg = ppo.PPOConfig(n_envs=4, n_steps=8, n_epochs=2, n_minibatches=2, n_updates=1)
    params, history = ppo.train_ppo(PLAT, wls, cfg, pcfg, device=CPU)
    assert np.isfinite(history[0]["loss"])
    init = networks.policy_init(torch.Generator().manual_seed(pcfg.seed), cfg.obs_size,
                                cfg.n_actions)
    assert _moved(list(init.parameters()), params) > 0


def test_curriculum_stages_ramp_and_train():
    target = tgen.GeneratorConfig(n_jobs=16, nb_res=16, mean_interarrival=300.0, seed=0)
    stages = curriculum.default_curriculum(target, n_stages=3, updates_per_stage=2)
    inter = [s[0].mean_interarrival for s in stages]
    assert inter[0] > inter[1] > inter[2] and inter[-1] == pytest.approx(300.0)
    cfg = dataclasses.replace(_cfg(max_steps=32), engine=EngineConfig(
        policy=RLController(), rl_decision_interval=600))
    acfg = a2c.A2CConfig(n_envs=4, n_steps=4, n_updates=2)
    params, history = curriculum.train_a2c_curriculum(PLAT, cfg, stages, acfg, device=CPU)
    assert [h["stage"] for h in history] == [0, 0, 1, 1, 2, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert all(bool(torch.isfinite(x).all()) for x in params.parameters())


def test_rollout_samples_on_the_device_from_its_generator():
    """Two rollouts from generators of one seed draw the same actions; the
    rollout reads the device once a step (the env's scheduler window)."""
    cfg = _cfg(max_steps=64)
    const = engine.make_const(PLAT, cfg.engine, device=CPU)
    wls = [tgen.generate_workload(tgen.GeneratorConfig(n_jobs=16, nb_res=16, seed=s))
           for s in range(4)]
    sims0 = a2c.make_batched_sims(PLAT, wls, cfg, device=CPU)
    grid, fresh = a2c._grid_and_reset(cfg, const, sims0)
    model = convert.policy_params_from_arrays(_jax_params(2, cfg.obs_size, cfg.n_actions),
                                              device=CPU)
    acts = []
    for _ in range(2):
        engine.HOST_SYNCS = 0
        _, _, roll = a2c.collect_rollout(model, fresh[0], fresh[1],
                                         torch.Generator().manual_seed(11), fresh, cfg,
                                         grid, 8)
        assert engine.HOST_SYNCS == 8
        acts.append(roll.actions)
    assert torch.equal(acts[0], acts[1]) and len(set(acts[0].flatten().tolist())) > 1


def test_rl_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.core.rl.env, repro_torch.core.rl.a2c, "
        "repro_torch.core.rl.ppo, repro_torch.core.rl.curriculum, "
        "repro_torch.core.rl.features, repro_torch.core.rl.rewards, "
        "repro_torch.core.rl.networks, repro_torch.training.checkpoint, "
        "repro_torch.training.optimizer, repro_torch.launch.sim\n"
        "import repro_torch.core.rl as r; r.EnvConfig; r.train_ppo\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes']\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
                         timeout=300)
    assert res.returncode == 0, res.stderr
