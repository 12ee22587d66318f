"""Data-parallel RL rollouts on the PyTorch port (``devices`` = D in
``core/rl/env.py``, ``a2c.py`` and ``ppo.py``) on the CPU, where D worker
processes stand in for the reference's forced host devices.

- ``shard_env_batch`` and the rollout resolver raise the reference's
  messages (an uneven batch, D < 1), and cut a batch into compact blocks;
- with given actions, each block's rows step bit for bit as the same rows
  of the unsharded batch;
- one A2C and one PPO update at D = 2 equal, bit for bit, the in-process
  mean of the unsharded update's gradients, each computed on its block with
  its block's generator (``shard_seed(seed, d)``), then one clip and one
  AdamW step (PPO: a mean a minibatch step); the workers' host reads reach
  the parent's counter;
- two updates of ``train_a2c`` and ``train_ppo`` at D = 2 give finite
  losses; an uneven ``n_envs`` raises before a worker starts.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.rl import a2c as ja2c
from repro.core.rl import env as jenv
from repro_torch.core import engine, shard
from repro_torch.core.policy import RLController
from repro_torch.core.rl import a2c, env, networks, ppo
from repro_torch.core.types import EngineConfig
from repro_torch.training.optimizer import adamw, apply_updates, clip_by_global_norm
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

CPU = "cpu"
PLAT = tplat.PlatformSpec(nb_nodes=16, t_switch_on=120, t_switch_off=180)
B, D, T = 4, 2, 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The workers run on one intra-op thread; so does this process, so
    that the in-process reference sums in the workers' order."""
    n = torch.get_num_threads()
    warm = [shard.mesh(D, CPU).submit(d, int, 0) for d in range(D)]
    torch.set_num_threads(1)
    for c in warm:
        c.result()
    yield
    torch.set_num_threads(n)


def _message(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return type(e).__name__, str(e)
    raise AssertionError("expected an exception")


def _cfg():
    return env.EnvConfig(engine=EngineConfig(policy=RLController(), rl_decision_interval=300),
                         max_steps=48)


@pytest.fixture(scope="module")
def batch():
    cfg = _cfg()
    wls = [tgen.generate_workload(tgen.GeneratorConfig(n_jobs=12, nb_res=16, seed=s))
           for s in range(B)]
    const = engine.make_const(PLAT, cfg.engine, device=CPU)
    sims0 = a2c.make_batched_sims(PLAT, wls, cfg, device=CPU)
    return cfg, const, sims0


# --------------------------------------------------------------------------
# the resolver and the blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["uneven batch", "uneven n_envs", "below one"])
def test_messages_are_the_references(monkeypatch, case):
    monkeypatch.setattr(jax, "device_count", lambda: 8)  # the reference's 8 devices
    x = np.zeros((15, 3), np.float32)
    port, ref = {
        "uneven batch": (lambda: env.shard_env_batch(torch.from_numpy(x), 8),
                         lambda: jenv.shard_env_batch(x, 8)),
        "uneven n_envs": (lambda: env.resolve_rollout_devices(8, None, 15, CPU),
                          lambda: ja2c._resolve_rollout_devices(8, jenv.EnvConfig(), 15)),
        "below one": (lambda: env.shard_env_batch(torch.from_numpy(x), 0),
                      lambda: jenv.shard_env_batch(x, 0)),
    }[case]
    assert _message(port) == _message(ref)


def test_one_device_and_none_are_unsharded(batch):
    cfg, _, sims0 = batch
    assert env.shard_env_batch(sims0) is sims0
    assert env.shard_env_batch(sims0, 1) is sims0
    assert env.resolve_rollout_devices(1, cfg.engine, B, CPU) is None
    assert env.resolve_rollout_devices(None, dataclasses.replace(
        cfg.engine, devices=2), B, CPU) == 2  # the config's count is the fallback


def test_blocks_are_compact_contiguous_rows(batch):
    _, _, sims0 = batch
    blocks = env.shard_env_batch(sims0, D)
    assert len(blocks) == D
    for d, blk in enumerate(blocks):
        for x, full in zip(blk, sims0):
            assert torch.equal(x, full[d * (B // D):(d + 1) * (B // D)])
            assert x.untyped_storage().nbytes() == x.numel() * x.element_size()


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_each_block_steps_as_the_unsharded_rows(batch, n_blocks):
    cfg, const, sims0 = batch
    gen = np.random.default_rng(5)
    actions = torch.from_numpy(gen.integers(0, cfg.n_actions, (T, B)).astype(np.int32))

    def run(sims):
        grid = env.make_env_grid(const, sims.t.shape[0])
        st, obs = env.batched_reset(cfg, grid, sims)
        kept = [obs]
        for t in range(T):
            st, obs, r, done, _ = env.batched_step(cfg, grid, st, actions[t, rows])
            kept += [obs, r, done]
        return st, kept

    rows = slice(None)
    full_st, full_kept = run(sims0)
    b = B // n_blocks
    for d, blk in enumerate(env.shard_env_batch(sims0, n_blocks)):
        rows = slice(d * b, (d + 1) * b)
        st, kept = run(blk)
        for f, x, y in zip(engine.SimState._fields, st.sim, full_st.sim):
            assert torch.equal(x, y[rows]), (d, f)
        assert all(torch.equal(x, y[rows]) for x, y in zip(kept, full_kept)), d


def test_block_seeds_derive_from_the_seed_and_the_index():
    seeds = [a2c.shard_seed(0, d) for d in range(4)] + [a2c.shard_seed(1, 0)]
    assert len(set(seeds)) == 5 and a2c.shard_seed(0, 3) == seeds[3]
    assert seeds[2] == int(np.random.SeedSequence((0, 2)).generate_state(1, np.uint32)[0])


# --------------------------------------------------------------------------
# one update against the in-process per-block mean
# --------------------------------------------------------------------------

def _policy(cfg, hidden=(16, 16)):
    return networks.policy_init(torch.Generator().manual_seed(0), cfg.obs_size,
                                cfg.n_actions, hidden)


def _blocks_in_process(cfg, const, sims0, seed):
    """Each block's grid, reset state and generator, as its worker has them."""
    out = []
    for d, blk in enumerate(env.shard_env_batch(sims0, D)):
        grid, fresh = a2c._grid_and_reset(cfg, const, blk)
        out.append(dict(grid=grid, fresh=fresh, states=fresh,
                        key=torch.Generator().manual_seed(a2c.shard_seed(seed, d))))
    return out


def _mean(grads):
    return [(g0 + g1) / 2 for g0, g1 in zip(*grads)]


def _step(opt, opt_state, params, grads, max_norm):
    grads, _ = clip_by_global_norm(grads, max_norm)
    updates, opt_state = opt.update(grads, opt_state, params)
    apply_updates(params, updates)
    return opt_state


def test_a2c_update_is_the_mean_of_the_blocks_gradients(batch):
    cfg, const, sims0 = batch
    acfg = a2c.A2CConfig(n_envs=B, n_steps=T, hidden=(16, 16))
    model, ref = _policy(cfg), _policy(cfg)
    update, opt = a2c.make_update_fn(cfg, const, sims0, acfg, devices=D)
    ts = a2c.TrainState(model, opt.init(model.parameters()), None, None, None)
    engine.HOST_SYNCS = 0
    ts, m = update(ts)
    syncs = engine.HOST_SYNCS

    blocks = _blocks_in_process(cfg, const, sims0, acfg.seed)
    engine.HOST_SYNCS = 0
    grads, losses = [], []
    for blk in blocks:
        _, _, roll = a2c.collect_rollout(ref, *blk["states"], blk["key"], blk["fresh"],
                                         cfg, blk["grid"], T)
        advs, returns = a2c.gae(roll, acfg.gamma, acfg.gae_lambda)
        loss, _ = a2c.a2c_loss(ref, roll, advs, returns, acfg)
        grads.append(torch.autograd.grad(loss, list(ref.parameters())))
        losses.append(loss.detach())
    assert engine.HOST_SYNCS == syncs > 0  # the workers' reads reached the parent
    params = list(ref.parameters())
    _step(adamw(lr=acfg.lr), adamw(lr=acfg.lr).init(params), params, _mean(grads),
          acfg.max_grad_norm)
    for got, want in zip(model.parameters(), ref.parameters()):
        assert torch.equal(got, want)
    assert float(m["loss"]) == float((losses[0] + losses[1]) / 2)
    assert list(m) == ["loss", "grad_norm", "mean_reward", "pg_loss", "vf_loss", "entropy"]


def test_ppo_update_is_the_mean_of_the_blocks_gradients(batch):
    cfg, const, sims0 = batch
    pcfg = ppo.PPOConfig(n_envs=B, n_steps=T, n_epochs=2, n_minibatches=2, hidden=(16, 16))
    model, ref = _policy(cfg), _policy(cfg)
    update, opt = ppo.make_update_fn(cfg, const, sims0, pcfg, devices=D)
    ts = a2c.TrainState(model, opt.init(model.parameters()), None, None, None)
    ts, m = update(ts)

    blocks = _blocks_in_process(cfg, const, sims0, pcfg.seed)
    for blk in blocks:
        _, _, roll = a2c.collect_rollout(ref, *blk["states"], blk["key"], blk["fresh"],
                                         cfg, blk["grid"], T)
        blk["data"], _ = ppo._rollout_samples(ref, roll, pcfg)
    params = list(ref.parameters())
    o = adamw(lr=pcfg.lr)
    state = o.init(params)
    n = T * (B // D)
    mb = n // pcfg.n_minibatches
    for _ in range(pcfg.n_epochs):
        perms = [torch.randperm(n, generator=blk["key"]) for blk in blocks]
        for i in range(pcfg.n_minibatches):
            grads = []
            for blk, perm in zip(blocks, perms):
                idx = perm[i * mb:(i + 1) * mb]
                loss, _ = ppo.ppo_loss(ref, tuple(x[idx] for x in blk["data"]), pcfg)
                grads.append(torch.autograd.grad(loss, params))
            state = _step(o, state, params, _mean(grads), pcfg.max_grad_norm)
    for got, want in zip(model.parameters(), ref.parameters()):
        assert torch.equal(got, want)
    assert np.isfinite(float(m["loss"])) and list(m) == ["loss", "mean_reward"]


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("learner", ["a2c", "ppo"])
def test_two_sharded_updates_give_finite_losses(learner):
    cfg = _cfg()
    wls = [tgen.generate_workload(tgen.GeneratorConfig(n_jobs=12, nb_res=16, seed=s))
           for s in range(2)]
    if learner == "a2c":
        lcfg = a2c.A2CConfig(n_envs=B, n_steps=4, n_updates=2, hidden=(16, 16))
        params, history = a2c.train_a2c(PLAT, wls, cfg, lcfg, devices=D, device=CPU)
    else:
        lcfg = ppo.PPOConfig(n_envs=B, n_steps=4, n_epochs=1, n_minibatches=2,
                             n_updates=2, hidden=(16, 16))
        params, history = ppo.train_ppo(PLAT, wls, cfg, lcfg, devices=D, device=CPU)
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    init = _policy(cfg)
    assert any(not torch.equal(a, b) for a, b in zip(init.parameters(), params.parameters()))


@pytest.mark.parametrize("learner", [a2c, ppo], ids=["a2c", "ppo"])
def test_an_uneven_batch_raises_before_a_worker_starts(batch, learner):
    cfg, const, sims0 = batch
    lcfg = (a2c.A2CConfig if learner is a2c else ppo.PPOConfig)(n_envs=B, hidden=(16, 16))
    before = set(shard._WORKERS)
    with pytest.raises(ValueError, match="n_envs=4 does not shard evenly across 3 devices"):
        learner.make_update_fn(cfg, const, sims0, lcfg, devices=3)
    assert set(shard._WORKERS) == before
