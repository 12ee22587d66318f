"""RL policy checkpoints and the ``RL`` labels of ``launch/sim`` in the
PyTorch port, against the JAX reference.

- A policy saved by the reference's ``save_policy`` loads in the port's
  ``load_policy`` with the same weights bit for bit (so the same logits to
  rtol 1e-5), and the reverse; a generic tree crosses through both
  ``Checkpointer``s with the same manifest, ``LATEST`` and retention.
- Every header error of ``load_policy`` is the reference's message.
- ``launch/sim`` with ``EASY RL``, ``EASY RL:groups`` (grouped tables) and
  ``EASY RL:dvfs`` and a checkpoint with random non-zero heads from a fixed
  seed (so the greedy action's top two logits differ by far more than f32
  rounding): the port on the CPU writes the reference's ``jobs.csv`` byte
  for byte and its ``metrics.json`` values (floats to rel 1e-5, the rest
  equal).
- A missing ``rl`` block, a label that disagrees with the checkpoint and a
  platform the observation does not fit raise the reference's ValueError.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rl import networks as jnet
from repro.launch.sim import run as run_ref
from repro.training import checkpoint as jck
from repro_torch.core import convert
from repro_torch.launch import sim as tsim
from repro_torch.training import checkpoint as tck
from repro_torch.workloads.platform import dvfs_platform_example, mixed_platform_example

CPU = "cpu"


def _jax_params(seed, obs_size, n_actions, hidden=(64, 64), head_std=1.0):
    p = jnet.policy_init(jax.random.PRNGKey(seed), obs_size, n_actions, hidden)
    rng = np.random.default_rng(seed)
    for head in ("pi", "v"):
        w = p[head][-1]["w"]
        p[head][-1]["w"] = jnp.asarray(rng.normal(0, head_std, w.shape).astype(np.float32))
        b = p[head][-1]["b"]
        p[head][-1]["b"] = jnp.asarray(rng.normal(0, head_std, b.shape).astype(np.float32))
    return jax.tree_util.tree_map(np.asarray, p)


META = dict(obs_size=20, n_actions=9, feature="compact", action="target_fraction",
            n_levels=9, hidden=(64, 64))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_reference_checkpoint_loads_in_the_port_and_the_reverse(tmp_path):
    p = _jax_params(0, 20, 9)
    jck.save_policy(str(tmp_path / "ref"), p, **META)
    model, meta = tck.load_policy(str(tmp_path / "ref"), device=CPU)
    assert meta["version"] == tck.POLICY_CKPT_VERSION == jck.POLICY_CKPT_VERSION
    for g, w in zip(_leaves(convert.policy_params_to_arrays(model)), _leaves(p)):
        assert np.array_equal(g, w)
    obs = np.random.default_rng(1).random((8, 20), dtype=np.float32)
    jl, _ = jax.vmap(jnet.policy_apply, (None, 0))(p, obs)
    tl, _ = model(torch.from_numpy(obs))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6 * float(np.abs(np.asarray(jl)).max()))
    assert (tl.argmax(-1).numpy() == np.asarray(jl).argmax(-1)).all()

    tck.save_policy(str(tmp_path / "port"), model, **META, step=3)
    back, jmeta = jck.load_policy(str(tmp_path / "port"))
    assert jmeta == meta
    for g, w in zip(_leaves(back), _leaves(p)):
        assert np.array_equal(np.asarray(g), w)
    with open(tmp_path / "ref" / "step_00000000" / "manifest.json") as f:
        ref_manifest = json.load(f)
    with open(tmp_path / "port" / "step_00000003" / "manifest.json") as f:
        port_manifest = json.load(f)
    assert port_manifest["leaves"] == ref_manifest["leaves"]
    assert [e["path"] for e in port_manifest["leaves"]][:3] == ["pi.0.b", "pi.0.w",
                                                               "torso.0.b"]


def test_checkpointer_publishes_atomically_and_keeps_the_last(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.int32(4), np.ones(3, np.int32)]}
    ck = tck.Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None
    for step in (1, 2, 5):
        ck.save(step, {**tree, "a": tree["a"] + step})
    assert ck.latest_step() == 5
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == [
        "step_00000002", "step_00000005"]
    assert (tmp_path / "LATEST").read_text() == "step_00000005"
    step, got = ck.restore(tree)
    assert step == 5 and np.array_equal(got["a"], tree["a"] + 5)
    # the reference reads the port's checkpoint, and the port the reference's
    _, ref_got = jck.Checkpointer(str(tmp_path)).restore(tree, step=2)
    assert np.array_equal(np.asarray(ref_got["a"]), tree["a"] + 2)
    jck.Checkpointer(str(tmp_path / "r")).save(7, tree)
    _, got = tck.Checkpointer(str(tmp_path / "r")).restore(tree)
    assert np.array_equal(got["b"][1], tree["b"][1])
    with pytest.raises(ValueError, match="checkpoint shape"):
        ck.restore({**tree, "a": np.zeros((3, 3), np.float32)})
    # a pointer to a step whose manifest is missing is not published
    (tmp_path / "LATEST").write_text("step_00000009")
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(tree)


def _message(fn, exc=ValueError):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["headerless", "version", "obs", "actions"])
def test_header_errors_are_the_reference_messages(tmp_path, case):
    d = str(tmp_path / "ck")
    p = _jax_params(1, 20, 9)
    kw = {}
    if case == "headerless":
        jck.Checkpointer(d).save(0, p)
    else:
        jck.save_policy(d, p, **META)
    if case == "version":
        path = tmp_path / "ck" / "step_00000000" / "manifest.json"
        m = json.loads(path.read_text())
        m["meta"]["version"] = 1
        path.write_text(json.dumps(m))
    if case == "obs":
        kw = dict(expect_obs_size=26)
    if case == "actions":
        kw = dict(expect_n_actions=27)
    assert _message(lambda: tck.load_policy(d, device=CPU, **kw)) == _message(
        lambda: jck.load_policy(d, **kw))
    with pytest.raises(FileNotFoundError):
        tck.load_policy(str(tmp_path / "empty"), device=CPU)


# --------------------------------------------------------------------------
# launch/sim with RL labels
# --------------------------------------------------------------------------

def _save_ckpt(path, plat_groups, feature, action, n_levels, n_actions, obs_size,
               grouped=False, dvfs=False, seed=2):
    p = _jax_params(seed, obs_size, n_actions)
    jck.save_policy(str(path), p, obs_size=obs_size, n_actions=n_actions,
                    feature=feature, action=action, n_levels=n_levels, hidden=(64, 64),
                    grouped=grouped, n_groups=plat_groups, dvfs=dvfs)
    return str(path)


LAUNCH = {
    "RL": dict(scheduler="EASY RL", platform=None, feature="compact",
               action="target_fraction", n_levels=9, grouped=False, dvfs=False,
               extra={"timeout": 300}),
    "RL:groups": dict(scheduler="EASY RL:groups", platform=mixed_platform_example,
                      feature="compact_groups", action="group_target_fraction",
                      n_levels=9, grouped=True, dvfs=False,
                      extra={"grouped_tables": True, "gantt": False}),
    "RL:dvfs": dict(scheduler="EASY RL:dvfs", platform=dvfs_platform_example,
                    feature="compact_dvfs", action="group_mode", n_levels=3,
                    grouped=False, dvfs=True, extra={"gantt": False}),
}


def _launch_config(tmp_path, name):
    c = LAUNCH[name]
    if c["platform"] is None:
        plat, groups = 16, 1
    else:
        c["platform"](16).save(str(tmp_path / "plat.json"))
        plat, groups = str(tmp_path / "plat.json"), 3
    from repro_torch.core.rl.actions import action_space_size
    from repro_torch.core.rl.features import feature_size

    ckpt = _save_ckpt(tmp_path / "ckpt", groups, c["feature"], c["action"],
                      c["n_levels"], action_space_size(c["action"], c["n_levels"], groups),
                      feature_size(c["feature"], 8, groups), c["grouped"], c["dvfs"])
    return {"workload": {"preset": "fig3_small", "n_jobs": 80}, "platform": plat,
            "scheduler": c["scheduler"], **c["extra"],
            "rl": {"checkpoint": ckpt, "decision_interval": 600}}


@pytest.mark.parametrize("name", sorted(LAUNCH))
def test_rl_labels_match_the_reference_run(tmp_path, name):
    cfg = _launch_config(tmp_path, name)
    ref = run_ref({**cfg, "out": str(tmp_path / "ref")})
    port = tsim.run({**cfg, "out": str(tmp_path / "port")}, device=CPU)
    assert set(port) == set(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert port[k] == pytest.approx(v, rel=1e-5), k
        else:
            assert port[k] == v, k
    names = ["jobs.csv"] + (["gantt.csv"] if cfg.get("gantt", True) else [])
    for fname in names:
        assert (tmp_path / "port" / fname).read_bytes() == \
            (tmp_path / "ref" / fname).read_bytes(), fname
    # the agent acted: the same run without its commands draws other energy
    on = {**cfg, "scheduler": "EASY AlwaysOn", "out": str(tmp_path / "on")}
    assert tsim.run(on, device=CPU)["total_energy_kwh"] != port["total_energy_kwh"]


def test_rl_errors_are_the_reference_messages(tmp_path):
    cfg = _launch_config(tmp_path, "RL")
    mixed_platform_example(16).save(str(tmp_path / "mixed.json"))
    one_group = _save_ckpt(tmp_path / "one_group", 1, "compact_groups",
                           "target_fraction", 9, 9, 26)
    cases = [
        {k: v for k, v in cfg.items() if k != "rl"},  # no rl block
        {**cfg, "scheduler": "EASY RL:groups"},  # grouped label, global policy
        {**cfg, "scheduler": "EASY RL:dvfs"},  # dvfs label, non-dvfs policy
        # a one-group observation on a three-group platform
        {**cfg, "platform": str(tmp_path / "mixed.json"),
         "rl": {"checkpoint": one_group}},
    ]
    for c in cases:
        c = {**c, "out": str(tmp_path / "o")}
        assert _message(lambda: tsim.run(c, device=CPU)) == _message(lambda: run_ref(c))
    bad = {**cfg, "rl": {**cfg["rl"], "checkpiont": "x"}}
    with pytest.raises(ValueError, match="rl config"):
        tsim.run(bad, device=CPU)


def test_a_bf16_leaf_is_refused_by_name(tmp_path):
    """The port restores numpy-native dtypes only (it imports no ml_dtypes):
    a reference checkpoint with a bfloat16 leaf fails naming that leaf."""
    tree = {"w": jnp.ones((2, 2), jnp.bfloat16), "b": np.zeros(2, np.float32)}
    jck.Checkpointer(str(tmp_path)).save(0, tree)
    with pytest.raises(ValueError, match="w: checkpoint leaf of dtype bfloat16"):
        tck.Checkpointer(str(tmp_path)).restore(
            {"w": np.zeros((2, 2), np.float32), "b": np.zeros(2, np.float32)})
