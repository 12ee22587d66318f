"""Tensor-parallel training over worker ranks (``repro_torch.training.
tensor_parallel``) against the reference's single-device step, on the CPU
with ``gloo``.

The reference's contract for a sharded step (``tests/test_distribution.py``
``test_data_parallel_train_step_matches_single_device``) is that it equals
the single-device step on the same global batch: loss within 1e-4, every
parameter within atol 5e-3 and rtol 5e-3. Sharding changes placement, not
semantics, so the port's grid is held to the reference's ``jax.jit``
single-device steps of ``make_optimizer("adamw", 1e-3)`` on its
``model.init(PRNGKey(0))`` parameters (carried across as arrays) and its
batch of 8 x 32 tokens from ``np.random.default_rng(0)``, two steps, to
those bounds and to the gradient's (each step's norm, the first moment):

* the reduced internlm2-1.8b (4 heads, 2 KV heads, f32) at (data, model) =
  (2, 2), and at (1, 4), where the 2 KV heads do not split 4 ways and
  ``wk``/``wv`` stay whole (each rank reads its query heads' KV head);
* the reduced qwen3-14b at (1, 2): the qk-norm gains, used on each rank's
  heads only, summed over the model group.

Beside them: the rank layout's kinds, two accumulated microbatches and a
prefill against the port's own single process, the refusals that name
ROADMAP item 12c.6, and ``launch/train.py --model-parallel 2 --device
cpu``: a crash at step 5 and its resume end on the uninterrupted run's
checkpoint bit for bit, and that checkpoint restores at M = 1 and trains
on as the M = 2 grid does. The reference's steps (a process of their own),
the launcher's crashing run and the four CPU workers start with the
module, and every grid here opens on those workers.
"""
import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import REPO, SRC
from repro_torch.configs import get_arch
from repro_torch.core import shard
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models.convert import leaves_to_tree, reference_leaves
from repro_torch.training import tensor_parallel as tp
from repro_torch.training import train_step as tts

CPU = torch.device("cpu")
LOSS_ATOL, ATOL, RTOL = 1e-4, 5e-3, 5e-3  # tests/test_distribution.py:34's bounds
NORM_RTOL = 1e-4  # each step's gradient norm
# the first step's AdamW first moment, kept in bf16: one bf16 ulp (2^-7) of
# each leaf's largest |element|, the most a rounding flip of any element moves
MU_ULP = 2.0 ** -7
ADAMW = functools.partial(tts.make_optimizer, "adamw", 1e-3)
ARCHS = ("internlm2-1.8b", "qwen3-14b")

# the reference's first two steps on one batch for each arch, in a process
# of its own: its parameters before and after each step, by the port's leaf
# names, and each step's loss and gradient norm
_REFERENCE = textwrap.dedent(
    """
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch
    from repro.models import build_model
    from repro.training import train_step as jts
    from repro_torch.configs import get_arch as tget
    from repro_torch.models import build_model as tbuild
    from repro_torch.models.convert import reference_leaves, tree_values

    out = {}
    for arch in %r:
        cfg = get_arch(arch, reduced=True).replace(remat=False)
        model = build_model(cfg)
        opt = jts.make_optimizer("adamw", 1e-3)
        step = jax.jit(jts.make_train_step(model, opt, jts.TrainStepConfig()))
        params = model.init(jax.random.PRNGKey(0))
        batch = {"tokens": jnp.asarray(
            np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 32)), jnp.int32)}
        p1, o1, m1 = step(params, opt.init(params), batch)
        p2, _, m2 = step(p1, o1, batch)
        leaves = reference_leaves(tbuild(tget(arch, reduced=True), "meta"))
        for tag, tree in (("before", params), ("step1", p1), ("step2", p2),
                          ("mu1", o1.inner.mu)):
            for leaf, v in zip(leaves, tree_values(leaves, tree)):
                out[f"{arch}|{tag}|{leaf.name}"] = np.asarray(v, np.float32)
        out[f"{arch}|tokens"] = np.asarray(batch["tokens"])
        for i, m in ((1, m1), (2, m2)):
            for key in ("loss", "grad_norm"):
                out[f"{arch}|{key}{i}"] = np.asarray(m[key], np.float32)
    np.savez(sys.argv[1], **out)
    """ % (ARCHS,))


def _argv(ckpt_dir, *extra, steps=8, model_parallel=2):
    return ["--reduced", "--device", "cpu", "--model-parallel", str(model_parallel),
            "--steps", str(steps), "--batch", "2", "--seq", "32", "--ckpt-every", "3",
            "--ckpt-dir", str(ckpt_dir), "--log-every", "100", *extra]


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Everything slow starts with the module and runs beside its cases:
    the reference's process, the launcher's crashing run (a process of its
    own: it exits hard) and the four CPU workers. This process runs on one
    intra-op thread meanwhile, as the workers do."""
    tmp = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    # each in a session of its own, so that a teardown that finds one still
    # running kills it with the workers it spawned (they hold its pipes)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(tmp / "reference.npz")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=env, cwd=REPO, start_new_session=True)
    crash = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_argv(tmp / "crashed", "--fail-at", "5")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO,
        start_new_session=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    shard.gather([shard.mesh(4, CPU).submit(d, int, 0) for d in range(4)])
    yield {"tmp": tmp, "reference": ref, "crash": crash}
    for proc in (ref, crash):
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:  # the session has ended
            pass
        proc.communicate(timeout=60)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(started):
    """For each arch: (the reference's parameter tree, the batch, and for
    each of its two steps the loss, the gradient norm and the parameters
    after it, one array a port leaf)."""
    out, err = started["reference"].communicate(timeout=300)
    assert started["reference"].returncode == 0, err
    got = np.load(started["tmp"] / "reference.npz")
    res = {}
    for arch in ARCHS:
        leaves = reference_leaves(build_model(get_arch(arch, reduced=True), "meta"))
        before = [got[f"{arch}|before|{leaf.name}"] for leaf in leaves]
        steps = [(float(got[f"{arch}|loss{i}"]), float(got[f"{arch}|grad_norm{i}"]),
                  [got[f"{arch}|step{i}|{leaf.name}"] for leaf in leaves]) for i in (1, 2)]
        mu = [got[f"{arch}|mu1|{leaf.name}"] for leaf in leaves]
        res[arch] = (leaves_to_tree(leaves, before), {"tokens": got[f"{arch}|tokens"]},
                     mu, steps)
    return res


def test_the_layout_keeps_kv_whole_where_heads_do_not_split():
    cfg = get_arch("internlm2-1.8b", reduced=True)  # 4 heads, 2 KV heads
    leaves = reference_leaves(build_model(cfg, "meta"))
    kinds = {m: {lay.path.split("/")[-1]: lay.kind
                 for lay in tp.rank_layout(cfg, {"data": 1, "model": m}, leaves)}
             for m in (2, 4)}
    assert kinds[2]["wk"] == kinds[2]["wq"] == kinds[2]["w_down"] == tp.SHARDED
    assert kinds[4]["wk"] == kinds[4]["wv"] == tp.PARTIAL and kinds[4]["wq"] == tp.SHARDED
    assert kinds[2]["ln1"] == kinds[2]["final_norm"] == tp.REPLICATED
    qwen = get_arch("qwen3-14b", reduced=True)
    lay = tp.rank_layout(qwen, {"data": 1, "model": 2},
                         reference_leaves(build_model(qwen, "meta")))
    assert {x.kind for x in lay if x.path.endswith(("q_norm", "k_norm"))} == {tp.PARTIAL}
    with pytest.raises(ValueError, match="3 query heads"):
        tp.rank_layout(cfg.replace(n_heads=3, n_kv_heads=1), {"data": 1, "model": 2}, leaves)


def test_accumulation_and_prefill_match_one_process():
    """Two accumulated microbatches at (2, 2) against the port's own step,
    and the grid's prefill logits against one process's."""
    cfg = get_arch("internlm2-1.8b", reduced=True)
    one = build_model(cfg, CPU).init(torch.Generator().manual_seed(3))
    leaves = reference_leaves(one)
    tree = leaves_to_tree(leaves, [leaf.stack().numpy() for leaf in leaves])
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 16))}
    step_cfg = tts.TrainStepConfig(accum_steps=2)
    opt = ADAMW()
    state = tts.init_opt_state(one, opt)
    prompt = torch.from_numpy(batch["tokens"][:2])
    want_logits, _ = one.prefill(prompt)
    _, m1 = tts.make_train_step(one, opt, step_cfg)(state, batch)
    with tp.Grid(cfg, 2, 4, device=CPU, params=tree, make_optimizer=ADAMW,
                 step_cfg=step_cfg) as grid:
        logits = grid.prefill(prompt)
        metrics = grid.step(batch)
        got, _ = grid.state()
    assert logits.shape == want_logits.shape
    torch.testing.assert_close(logits, want_logits, atol=1e-5, rtol=1e-5)
    assert abs(metrics["loss"] - float(m1["loss"])) < 1e-5
    assert metrics["grad_norm"] == pytest.approx(float(m1["grad_norm"]), rel=1e-5)
    for leaf, a in zip(leaves, got):
        torch.testing.assert_close(a, leaf.stack(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("change", [
    {"arch": "qwen2-moe-a2.7b"}, {"arch": "zamba2-2.7b"}, {"fsdp": True},
    {"sharding_mode": "fsdp_sp"}, {"optimizer": "adafactor"}, {"compression": "int8"}])
def test_other_archs_and_layouts_raise_naming_the_roadmap_item(change):
    change = dict(change)
    cfg = get_arch(change.pop("arch", "internlm2-1.8b"), reduced=True)
    step_cfg = tts.TrainStepConfig(compression=change.pop("compression", None))
    cfg = cfg.replace(**change)
    with pytest.raises(NotImplementedError, match="item 12c.6"):
        tp.Grid(cfg, 2, device=CPU, make_optimizer=ADAMW, step_cfg=step_cfg)


def test_the_backend_follows_the_cards():
    assert tp.default_backend(shard.Mesh("cpu", [0, 1])) == "gloo"
    assert tp.default_backend(shard.Mesh("cuda", [0, 1])) == "nccl"
    assert tp.default_backend(shard.Mesh("cuda", [0, 0])) == "gloo"  # nccl refuses it
    cfg = get_arch("internlm2-1.8b", reduced=True)
    for backend, why in (("nccl", "nccl takes one card a rank"), ("mpi", "one of")):
        with pytest.raises(ValueError, match=why):  # before any rank opens
            tp.Grid(cfg, 2, device=CPU, backend=backend, make_optimizer=ADAMW)


# ---------------------------------------------------------------- the launcher

def _arrays(ckpt_dir, step):
    d = os.path.join(ckpt_dir, "internlm2-1.8b", f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        entries = json.load(f)["leaves"]
    return {e["path"]: np.load(os.path.join(d, e["file"])) for e in entries}


def test_launcher_crash_and_resume_at_m2_and_restore_at_m1(started, capsys):
    tmp = started["tmp"]
    straight, crashed = tmp / "straight", tmp / "crashed"
    done0 = ttrain.main(_argv(straight))
    out1, err1 = started["crash"].communicate(timeout=300)
    assert started["crash"].returncode == 17, err1
    assert "simulated failure at step 5" in out1 and "backend gloo" in out1
    capsys.readouterr()
    done1 = ttrain.main(_argv(crashed))
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out and '"steps_run": 5' in out
    assert done1["last_loss"] == done0["last_loss"] and done0["steps_run"] == 8
    a, b = _arrays(straight, 8), _arrays(crashed, 8)
    assert sorted(a) == sorted(b) and "opt.inner.mu.stages.0.attn.wk" in a
    for path in a:  # parameters and optimizer state, bit for bit
        assert a[path].dtype == b[path].dtype and a[path].tobytes() == b[path].tobytes(), path
    # the M = 2 checkpoint trains on at M = 1 as it does at M = 2
    one = tmp / "one"
    shutil.copytree(straight, one)
    m2 = ttrain.main(_argv(straight, steps=10))
    m1 = ttrain.main(_argv(one, steps=10, model_parallel=1))
    out = capsys.readouterr().out
    assert out.count("[train] resumed from step 8") == 2 and m1["steps_run"] == 2
    assert m1["last_loss"] == pytest.approx(m2["last_loss"], rel=1e-5)
    assert "grid" in out and out.count("grid data 1 x model 2") == 1


# ---------------------------------------------------------------- the reference (last: its
# process runs beside the cases above)

@pytest.mark.parametrize("arch,data,model", [("internlm2-1.8b", 2, 2),
                                             ("internlm2-1.8b", 1, 4),
                                             ("qwen3-14b", 1, 2)])
def test_a_grid_step_is_the_references_single_device_step(reference, arch, data, model):
    """Two steps on one batch. A first AdamW step moves each element by
    about lr = 1e-3 whatever its gradient's size, inside the reference
    test's parameter bounds, so beside them the gradient itself is held:
    each step's gradient norm at rel 1e-4, the first step's first moment
    (0.1 x the clipped gradient, every element) to one bf16 ulp of its
    leaf's largest, and the second step's loss, which the first step's
    move sets, at 1e-4."""
    params, batch, want_mu, want = reference[arch]
    cfg = get_arch(arch, reduced=True)
    got, mus = [], []
    with tp.Grid(cfg, model, data * model, device=CPU, params=params,
                 make_optimizer=ADAMW) as grid:
        assert grid.backend == "gloo" and grid.mesh == {"data": data, "model": model}
        for _ in want:
            metrics = grid.step(batch)
            after, opt = grid.state()
            got.append((metrics["loss"], metrics["grad_norm"], after))
            mus.append(opt.inner.mu)
    meta = reference_leaves(build_model(cfg, "meta"))
    for i, ((loss, norm, after), (want_loss, want_norm, want_after)) in enumerate(
            zip(got, want), 1):
        assert abs(loss - want_loss) < LOSS_ATOL, (i, loss, want_loss)
        assert norm == pytest.approx(want_norm, rel=NORM_RTOL), (i, norm, want_norm)
        for leaf, a, b in zip(meta, after, want_after):
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {i}: {leaf.name}")
    for leaf, a, b in zip(meta, mus[0], want_mu):  # the first moment: 0.1 x the clipped gradient
        bound = MU_ULP * float(np.abs(b).max())
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=bound,
                                   err_msg=f"the first step's gradient of {leaf.name}")
