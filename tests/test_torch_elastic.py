"""Elastic resharding on the PyTorch port (``repro_torch.training.elastic``)
on the CPU, where CPU worker processes stand in for the reference's devices.

- ``plan_batch``, ``shrink_env_axis`` and ``grow_env_axis`` equal the
  reference's (``repro.training.elastic``) in process: the plans, the
  resized values, and the messages of the refused batches;
- ``reshard`` at 4 -> 2 -> 4 CPU workers with
  ``test_elastic_reshard_preserves_values``' ``sharding_fn`` shape (split
  the 2-d leaves, replicate the rest) keeps values, dtypes and shapes bit
  for bit, each worker holding its ``shard.block_bounds`` rows;
- ``surviving_mesh`` sizes a data x model grid, onto whose model axis
  ``reshard`` refuses to place a state (ROADMAP Queue 1 item 12c.6), and
  refuses more workers than visible cards and no card by default;
- a grouped env batch shrunk to 3 envs and grown back to 4 steps once with
  row 3's action row 0's: row 3 equals row 0 bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine, shard
from repro_torch.core.policy import RLController
from repro_torch.core.rl import a2c, env
from repro_torch.core.types import EngineConfig
from repro_torch.training import elastic as te
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def workers():
    warm = [shard.mesh(4, CPU).submit(d, int, 0) for d in range(4)]
    for c in warm:
        c.result()


def _message(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the message is what is compared
        return type(e).__name__, str(e)
    raise AssertionError("expected an exception")


# --------------------------------------------------------------------------
# the plan and the env axis against the reference
# --------------------------------------------------------------------------

PLANS = [(256, 8, 8), (256, 4, 8), (96, 3, 16), (24, 6, 1), (7, 7, 1), (64, 1, 64),
         (256, 3, 8), (10, 2, 0), (12, 2, 4), (30, 1, 7)]


@pytest.mark.parametrize("case", PLANS)
def test_plan_batch_is_the_references(case):
    from repro.training.elastic import plan_batch as jplan

    def port():
        return te.plan_batch(*case)

    def ref():
        return jplan(*case)

    try:
        want = ref()
    except ValueError:
        assert _message(port) == _message(ref)
        return
    got = port()
    assert (got.global_batch, got.per_device, got.accum_steps, got.dp_degree) == (
        want.global_batch, want.per_device, want.accum_steps, want.dp_degree)
    assert got.per_device * got.accum_steps * got.dp_degree == case[0]


def test_both_refusals_are_among_the_plans():
    refused = [c for c in PLANS if _refused(c)]
    assert refused == [(256, 3, 8), (10, 2, 0)]  # not divisible; max_per_device 0


def _refused(case):
    try:
        te.plan_batch(*case)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("counts", [(5, 8), (8, 8), (3, 7), (1, 4)])
def test_env_axis_resize_is_the_references(counts):
    import jax.numpy as jnp

    from repro.training.elastic import grow_env_axis as jgrow
    from repro.training.elastic import shrink_env_axis as jshrink

    small, big = counts
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    k = rng.integers(0, 9, (8,)).astype(np.int32)
    tree = {"x": torch.from_numpy(x), "pair": (torch.from_numpy(k), torch.from_numpy(x[:, 0]))}
    jtree = {"x": jnp.asarray(x), "pair": (jnp.asarray(k), jnp.asarray(x[:, 0]))}
    got_small, want_small = te.shrink_env_axis(tree, small), jshrink(jtree, small)
    got_big, want_big = te.grow_env_axis(got_small, big), jgrow(want_small, big)
    for got, want in ((got_small, want_small), (got_big, want_big)):
        for a, b in zip([got["x"], *got["pair"]], [want["x"], *want["pair"]]):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got_small["x"].untyped_storage().nbytes() == small * 3 * 4  # a compact copy


# --------------------------------------------------------------------------
# reshard
# --------------------------------------------------------------------------

def split_2d(mesh, shapes):
    """test_elastic_reshard_preserves_values' sharding_fn: split the 2-d
    leaves' leading axis, replicate the rest."""
    return shard.tree_map(lambda s: te.SPLIT if s.ndim == 2 else te.REPLICATE, shapes)


def _tree():
    rng = np.random.default_rng(4)
    return {
        "a": torch.arange(64.0).reshape(8, 8),
        "b": torch.ones((3,)),
        "bf16": torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32)).bfloat16(),
        "ids": (torch.from_numpy(rng.integers(-9, 9, (3, 2)).astype(np.int32)),
                torch.tensor(7, dtype=torch.int64)),
        "mask": [torch.from_numpy(rng.integers(0, 2, (4,)).astype(bool))],
        "n": 3,
    }


def _same(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
            and torch.equal(a, b))


def _all_same(got, want):
    same = []
    shard.tree_map(lambda a, b: same.append(_same(a, b)) or a, got, want)
    return len(same) == 6 and all(same) and got["n"] == want["n"]


def _held(state):
    return {k: tuple(v.shape) for k, v in state.items() if torch.is_tensor(v)}


def test_reshard_four_two_four_keeps_values_bit_for_bit():
    tree = _tree()
    t4 = te.reshard(tree, te.surviving_mesh(4, 1, device=CPU), split_2d)
    t2 = te.reshard(t4, te.surviving_mesh(2, 1, device=CPU), split_2d)  # half the fleet died
    assert _all_same(t2.gather(), tree)
    t4b = te.reshard(t2, te.surviving_mesh(4, 1, device=CPU), split_2d)  # nodes came back
    assert _all_same(t4b.gather(), tree) and _all_same(t4.gather(), tree)
    # each worker holds its rows (np.array_split's cut) and the whole rest
    held = t4b._resident.call(_held)
    for d, (lo, hi) in enumerate(shard.block_bounds(8, 4)):
        assert held[d]["a"] == (hi - lo, 8) and held[d]["b"] == (3,)
    assert [h["bf16"][0] for h in held] == [hi - lo for lo, hi in shard.block_bounds(5, 4)]
    for p in (t4, t2, t4b):
        p.close()


def test_reshard_over_more_workers_than_rows():
    tree = {"a": torch.arange(6.0).reshape(2, 3)}
    placed = te.reshard(tree, te.surviving_mesh(4, 1, device=CPU), split_2d)
    assert _same(placed.gather()["a"], tree["a"])  # two workers hold no row
    placed.close()


def test_bad_placements_raise():
    tree = {"a": torch.zeros(4, 2), "s": torch.tensor(1.0)}
    mesh = te.surviving_mesh(2, 1, device=CPU)
    with pytest.raises(ValueError, match="a placement is one of"):
        te.reshard(tree, mesh, lambda m, s: {"a": "P(data)", "s": te.REPLICATE})
    with pytest.raises(ValueError, match="0-d leaf cannot split"):
        te.reshard(tree, mesh, lambda m, s: {"a": te.SPLIT, "s": te.SPLIT})
    with pytest.raises(ValueError, match="a tree of keys"):
        te.reshard(tree, mesh, lambda m, s: {"a": te.SPLIT})


# --------------------------------------------------------------------------
# surviving_mesh
# --------------------------------------------------------------------------

def test_surviving_mesh_sizes():
    assert len(te.surviving_mesh(3, 1, device=CPU)) == 3
    assert te.surviving_mesh(4, 1, ("data", "model"), device=CPU).device_type == "cpu"
    with pytest.raises(ValueError, match="no device survives"):
        te.surviving_mesh(0, 1, device=CPU)


def test_surviving_mesh_refuses_a_model_axis():
    # surviving_mesh sizes a data x model grid; resharding onto its model
    # axis raises (no worker starts)
    mesh = te.surviving_mesh(9, 2, device=CPU)
    assert len(mesh) == 8 and mesh.shape == {"data": 4, "model": 2}
    assert te.surviving_mesh(3, 1, ("dp", "mp"), device=CPU).shape == {"dp": 3, "mp": 1}
    with pytest.raises(NotImplementedError, match="item 12c.6"):
        te.reshard({"a": torch.zeros(4, 2)}, mesh, lambda m, s: {"a": te.SPLIT})


def test_surviving_mesh_refuses_more_than_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with shard.pinned_cards([0, 0]):
        with pytest.raises(ValueError, match="devices=3 exceeds the 2 visible device"):
            te.surviving_mesh(3, 1, device="cuda")
        assert te.surviving_mesh(2, 1, device="cuda").cards == (0, 0)  # no worker starts


def test_surviving_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.surviving_mesh(2, 1)


# --------------------------------------------------------------------------
# a resized env batch steps
# --------------------------------------------------------------------------

def test_a_grown_env_batch_steps_its_copies_as_their_rows():
    plat = tplat.mixed_platform_example(16)
    cfg = env.EnvConfig(
        engine=EngineConfig(policy=RLController(grouped=True), rl_decision_interval=300,
                            grouped_tables=True),
        feature="compact_groups", action="group_target_fraction",
        reward="group_waste_wait", n_groups=plat.n_groups(), max_steps=48)
    wls = [tgen.generate_workload(tgen.GeneratorConfig(n_jobs=12, nb_res=16, seed=s))
           for s in range(4)]
    const = engine.make_const(plat, cfg.engine, device=CPU)
    sims0 = a2c.make_batched_sims(plat, wls, cfg, device=CPU)
    st, _ = env.batched_reset(cfg, env.make_env_grid(const, 4), sims0)
    placed = te.reshard(st, te.surviving_mesh(2, 1, device=CPU),
                        lambda m, s: shard.tree_map(lambda _: te.SPLIT, s))
    back = placed.gather()
    placed.close()
    assert all(torch.equal(a, b) for a, b in zip(shard.leaves(back), shard.leaves(st)))
    grown = te.grow_env_axis(te.shrink_env_axis(back, 3), 4)
    actions = torch.tensor([1, 4, 7, 1], dtype=torch.int32) % cfg.n_actions
    for _ in range(3):
        grown, obs, r, done, _ = env.batched_step(cfg, env.make_env_grid(const, 4), grown,
                                                  actions)
        bad = [f for f, x in zip(engine.SimState._fields, grown.sim)
               if not torch.equal(x[3], x[0])]
        assert not bad, bad
        assert torch.equal(obs[3], obs[0]) and torch.equal(r[3], r[0])
        assert bool(done[3] == done[0]) and int(grown.steps[3]) == int(grown.steps[0])
