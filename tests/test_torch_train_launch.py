"""The port's LM training runtime around the train step, against the
reference's: the token pipeline byte for byte, the straggler watchdog on a
fake clock, training checkpoints in bf16 written by either package and
restored by the other, ``save_async``/``wait`` and ``restore_or_init``,
and ``python -m repro_torch.launch.train``: a crash at step 12 and a resume
from step 10 end on the parameters and optimizer state of an
uninterrupted run bit for bit (on the CPU), in checkpoints the reference
restores. ``--model-parallel`` on a non-dense arch and the mesh pins of
``TrainStepConfig`` raise naming ROADMAP item 12c.6, and no module of the runtime imports JAX
or the reference package.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import build_model as jbuild
from repro.training import checkpoint as jck
from repro.training import stragglers as jstrag
from repro.training import train_step as jts
from repro_torch.configs import get_arch
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models.convert import (
    leaves_to_tree, params_from_arrays, params_to_arrays, reference_leaves, tree_values,
)
from repro_torch.training import checkpoint as tck
from repro_torch.training import optimizer as topt
from repro_torch.training import stragglers as tstrag
from repro_torch.training import train_step as tts
from test_torch_train_step import one_torch_thread  # noqa: F401 (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internlm2-1.8b"


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("num_hosts", [1, 2])
def test_token_stream_batches_are_the_reference_bytes(num_hosts):
    for host in range(num_hosts):
        kw = dict(vocab_size=5000, seq_len=48, global_batch=4, seed=3, host_id=host,
                  num_hosts=num_hosts)
        ours, theirs = tpipe.TokenStream(**kw), jpipe.TokenStream(**kw)
        for i in (0, 1, 7, 123):
            a, b = ours.batch_at(i)["tokens"], theirs.batch_at(i)["tokens"]
            assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


def test_prefetch_iterator_with_front_end_extras_is_the_reference_stream():
    cfg, jcfg = get_arch("internvl2-26b", reduced=True), jget_arch("internvl2-26b", reduced=True)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=0)
    ours = tpipe.make_batch_iterator(tpipe.TokenStream(**kw), start_index=3,
                                     extra_fn=ttrain.modality_extras(cfg))
    theirs = jpipe.make_batch_iterator(jpipe.TokenStream(**kw), start_index=3,
                                       extra_fn=jtrain.modality_extras(jcfg))
    try:
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert sorted(a) == sorted(b) == ["image_embeds", "tokens"]
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------- watchdog

def test_watchdog_on_a_fake_clock_is_the_reference():
    durations = [5.0, 4.0] + [1.0] * 6 + [1.1, 5.0, 1.0, 5.0, 5.0, 5.0, 1.0, 4.0, 4.0, 4.0]

    def run(mod):
        t = [0.0]
        fired = []
        wd = mod.StepWatchdog(mod.WatchdogConfig(patience=3, threshold=3.0),
                              on_straggler=lambda s, dt, base: fired.append((s, dt, base)),
                              clock=lambda: t[0])
        for d in durations:
            with wd:
                t[0] += d
        return wd.fired, wd.baseline, wd.history, fired

    ours, theirs = run(tstrag), run(jstrag)
    assert ours == theirs and ours[0] == 2
    times = np.array([1.0, 1.1, 0.9, 3.0, 1.05])
    assert tstrag.attribute(times) == jstrag.attribute(times) == ([3], 1.05)


# ---------------------------------------------------------------- checkpoints

def _batch(cfg, i=0):
    return tpipe.TokenStream(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                             seed=0).batch_at(i)


def _flat(tree):
    """{path: float32 numpy} of a tree of tensors or arrays (either package)."""
    def host(x):
        return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)
    return {jax.tree_util.keystr(p): host(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bf16():
    return (get_arch(ARCH, reduced=True).replace(dtype_name="bfloat16"),
            jget_arch(ARCH, reduced=True).replace(dtype_name="bfloat16"))


def test_a_bf16_training_checkpoint_of_the_port_restores_in_the_reference(tmp_path):
    cfg, jcfg = _bf16()
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    opt = tts.make_optimizer("adamw", 1e-3)
    state, _ = tts.make_train_step(model, opt)(tts.init_opt_state(model, opt), _batch(cfg))
    leaves = reference_leaves(model)
    tree = {"params": leaves_to_tree(leaves, [leaf.stack() for leaf in leaves]),
            "opt": tts.opt_state_to_tree(state, leaves)}
    tck.Checkpointer(str(tmp_path)).save(1, tree)

    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    like = {"params": shapes,
            "opt": jax.eval_shape(jts.make_optimizer("adamw", 1e-3).init, shapes)}
    step, got = jck.Checkpointer(str(tmp_path)).restore(like)
    assert step == 1 and int(got["opt"].step) == 1
    assert {str(x.dtype) for x in jax.tree_util.tree_leaves(got["params"])} == {"bfloat16"}
    want, have = _flat(tree), _flat(got)
    assert sorted(want) == sorted(have)
    assert all(np.array_equal(want[k], have[k]) for k in want)
    assert np.abs(have["['opt'].inner.mu['stages'][0]['attn']['wq']"]).max() > 0


def test_a_bf16_training_checkpoint_of_the_reference_restores_in_the_port(tmp_path):
    cfg, jcfg = _bf16()
    jmodel = jbuild(jcfg)
    jo = jts.make_optimizer("adamw", 1e-3)
    params = jmodel.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    p1, o1, _ = jax.jit(jts.make_train_step(jmodel, jo))(params, jo.init(params), batch)
    jck.Checkpointer(str(tmp_path)).save(1, {"params": p1, "opt": o1})

    model = build_model(cfg, "cpu")
    opt = tts.make_optimizer("adamw", 1e-3)
    leaves = reference_leaves(model)
    like = {"params": leaves_to_tree(leaves, [leaf.stack() for leaf in leaves]),
            "opt": tts.opt_state_to_tree(tts.init_opt_state(model, opt), leaves)}
    step, tree = tck.Checkpointer(str(tmp_path)).restore(like)
    for leaf, value in zip(leaves, tree_values(leaves, tree["params"])):
        assert value.dtype == torch.bfloat16
        leaf.write(value)
    state = tts.opt_state_from_tree(tree["opt"], leaves, "cpu")
    assert step == 1 and int(state.step) == 1
    assert isinstance(state, topt.OptState) and all(
        m.dtype == torch.bfloat16 for m in state.inner.mu + state.inner.nu)
    want = _flat(p1)
    for k, v in _flat(params_to_arrays(model)).items():
        assert np.array_equal(v, want[k]), k
    for m, w in zip(state.inner.mu, tree_values(leaves, o1.inner.mu)):
        assert np.array_equal(m.float().numpy(), np.asarray(w, np.float32))


def test_save_async_writes_a_copy_and_wait_reraises(tmp_path):
    ck = tck.Checkpointer(str(tmp_path / "a"))
    w = torch.ones(4, dtype=torch.bfloat16)
    ck.save_async(5, {"w": w, "step": np.int32(5)})
    w.add_(1)  # the caller moves on at once; the write holds the values it was given
    ck.wait()
    step, tree = ck.restore({"w": torch.zeros(4, dtype=torch.bfloat16), "step": np.int32(0)})
    assert step == 5 and torch.equal(tree["w"], torch.ones(4, dtype=torch.bfloat16))
    with open(tmp_path / "a" / "step_00000005" / "manifest.json") as f:
        assert [e["dtype"] for e in json.load(f)["leaves"]] == ["int32", "bfloat16"]

    bad = tck.Checkpointer(str(tmp_path / "b"))
    os.rmdir(bad.dir)
    open(bad.dir, "w").close()  # the writer's directory is now a file
    bad.save_async(1, {"w": w})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # the error is raised once


def test_restore_or_init(tmp_path):
    ck = tck.Checkpointer(str(tmp_path))
    calls = []

    def init():
        calls.append(1)
        return {"w": np.zeros(3, np.float32), "opt": topt.OptState(np.int32(0), None)}

    step, tree = tck.restore_or_init(ck, init)
    assert step == 0 and len(calls) == 1
    ck.save(7, {"w": np.arange(3, dtype=np.float32), "opt": topt.OptState(np.int32(7), None)})
    step, tree = tck.restore_or_init(ck, init)
    assert step == 7 and tree["w"].tolist() == [0.0, 1.0, 2.0]
    assert isinstance(tree["opt"], topt.OptState) and tree["opt"].step == 7
    assert tree["opt"].inner is None


# ---------------------------------------------------------------- the launcher

def _argv(ckpt_dir, *extra):
    return ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "20", "--batch", "2",
            "--seq", "32", "--ckpt-every", "5", "--ckpt-dir", str(ckpt_dir), "--log-every",
            "100", *extra]


def _step_arrays(ckpt_dir, step):
    d = os.path.join(ckpt_dir, ARCH, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        entries = json.load(f)["leaves"]
    return {e["path"]: np.load(os.path.join(d, e["file"])) for e in entries}


def test_launcher_crash_and_resume_equal_an_uninterrupted_run(tmp_path, capsys):
    """The crashing run is a process of its own (it exits hard); the
    uninterrupted run, beside it, and the resumed run are calls of
    ``main``. All three on one intra-op thread, as this module runs."""
    straight, crashed = tmp_path / "straight", tmp_path / "crashed"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *_argv(crashed, "--fail-at", "12")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        done0 = ttrain.main(_argv(straight))
    finally:
        out1, err1 = proc.communicate(timeout=300)
    assert proc.returncode == 17, err1  # the simulated hard failure
    assert "simulated failure at step 12" in out1
    capsys.readouterr()
    done2 = ttrain.main(_argv(crashed))
    out2 = capsys.readouterr().out
    assert "[train] resumed from step 10" in out2 and '"steps_run": 10' in out2
    assert done0["steps_run"] == 20 and done2["steps_run"] == 10
    assert done2["last_loss"] == done0["last_loss"]

    a, b = _step_arrays(straight, 20), _step_arrays(crashed, 20)
    assert sorted(a) == sorted(b) and "opt.inner.nu.stages.0.mlp.w_up" in a
    for path in a:  # parameters and optimizer state, bit for bit
        assert a[path].dtype == b[path].dtype and a[path].tobytes() == b[path].tobytes(), path

    # the reference restores the launcher's checkpoint, and its eval step
    # gives the port's loss on those parameters
    jmodel = jbuild(jget_arch(ARCH, reduced=True))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    like = {"params": shapes, "opt": jax.eval_shape(
        jts.make_optimizer("adamw", 1e-3).init, shapes)}
    step, got = jck.Checkpointer(str(straight / ARCH)).restore(like)
    assert step == 20 and int(got["opt"].step) == 20
    batch = _batch(get_arch(ARCH, reduced=True), 20)
    want = jax.jit(jts.make_eval_step(jmodel))(got["params"],
                                               {"tokens": jnp.asarray(batch["tokens"])})
    model = params_from_arrays(get_arch(ARCH, reduced=True),
                               jax.tree_util.tree_map(np.asarray, got["params"]), "cpu")
    loss = tts.make_eval_step(model)(batch)["loss"]
    assert float(loss) == pytest.approx(float(want["loss"]), rel=1e-5)


def test_model_parallel_and_mesh_pins_raise_naming_the_roadmap_item():
    # a dense decoder trains on a rank grid (tests/test_torch_tensor_parallel.py);
    # a non-dense arch under --model-parallel 2 still raises, before any worker starts
    with pytest.raises(NotImplementedError, match="item 12c.6"):
        ttrain.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
                     "--model-parallel", "2"])
    model = build_model(get_arch(ARCH, reduced=True), "cpu")
    for cfg in (tts.TrainStepConfig(batch_axes=("data",)), tts.TrainStepConfig(grad_specs={})):
        with pytest.raises(NotImplementedError, match="item 12c.6"):
            tts.make_train_step(model, topt.sgd(), cfg)


def test_the_runtime_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import repro_torch.data.pipeline, repro_torch.launch.train, "
        "repro_torch.models.convert, repro_torch.training.checkpoint, "
        "repro_torch.training.compression, repro_torch.training.optimizer, "
        "repro_torch.training.stragglers, repro_torch.training.train_step\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
