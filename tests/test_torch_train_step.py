"""The port's train step (``repro_torch.training.train_step``) against the
reference's ``make_train_step``, for the dense archs at their reduced
configurations (f32; the others in ``test_torch_train_step_mixers.py``),
from the reference's own parameters carried across with
``params_from_arrays``.

One SGD step: ``loss``, ``ce``, ``aux`` and ``grad_norm`` within 1e-5
relative and every reference leaf after the step (read back with
``params_to_arrays``) within 1e-5 of the leaf's largest entry — gradients
are compared through SGD, whose update is linear in them. Three steps of
the arch's own ``make_optimizer`` (AdamW with bf16 moments, or
Adafactor): losses within 1e-5 relative (AdamW's first steps are close to
``-lr * sign(g)``, so parameters are not compared there). On internlm2:
``accum_steps=4`` and ``compression="int8"``/``"topk"`` inside the step,
against the reference's (under int8, an element on a rounding boundary may
tip by one int8 step).

The batches are the reference's ``TokenStream`` batches (one target set to
-1, which the loss masks) with the launcher's seeded image embeds or
encoder frames. Each arch's JAX model, parameters and batches are built once
a process (``reference``) and shared by every check that runs it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.train import modality_extras
from repro_torch.models.convert import params_from_arrays, params_to_arrays
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

# the dense archs here; the MoE, recurrent and encoder-decoder ones in
# tests/test_torch_train_step_mixers.py, which runs the same two checks
DENSE = ("glm4-9b", "internlm2-1.8b", "internvl2-26b", "qwen3-14b", "stablelm-3b")
B, S = 4, 32  # S a multiple of the xLSTM's and zamba2's GLA chunk (16)
SGD_LR = 0.5
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread for the module, then put back:
    its ops are tiny, and beside other test processes a pool of spinning
    threads costs more than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(cfg, n=3):
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    extras = modality_extras(cfg)
    out = []
    for i in range(n):
        batch = extras(stream.batch_at(i), i)
        if i == 0:
            batch["tokens"][1, 5] = -1  # a masked target
        out.append(batch)
    return out


def _tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


@functools.lru_cache(maxsize=None)
def reference(arch):
    """(arch, the JAX model, its params, the params as numpy, batches),
    built once a process: the checks only read them (the port copies the
    numpy tree into its own tensors)."""
    jmodel = jbuild(jget_arch(arch, reduced=True))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))  # one program, not an op at a time
    return arch, jmodel, params, _tree_np(params), _batches(get_arch(arch, reduced=True))


@pytest.fixture(scope="module", params=DENSE)
def ref(request):
    return reference(request.param)


def _port(arch, tree):
    return params_from_arrays(get_arch(arch, reduced=True), tree, "cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_rel(got, want, what):
    assert abs(float(got) - float(want)) <= REL * abs(float(want)), (what, got, want)


def _assert_leaves(model, jparams, what, before=None):
    """Every leaf within 1e-5 of its largest entry. With ``before`` (the
    parameters before an int8-compressed step), an element may also differ
    by one int8 step of its leaf's update (the largest update over 127):
    a gradient that sits on a rounding boundary tips one way in one
    framework and the other way in the other, on at most 1 % of a leaf."""
    want = jax.tree_util.tree_flatten_with_path(_tree_np(jparams))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(params_to_arrays(model))[0])
    old = {} if before is None else dict(jax.tree_util.tree_flatten_with_path(before)[0])
    assert len(got) == len(want)
    for path, w in want:
        g, name = got[path], jax.tree_util.keystr(path)
        assert g.shape == w.shape, (what, name)
        err = np.abs(g - w)
        tol = REL * float(np.max(np.abs(w)))
        if path in old and w.size >= 1024:
            step = float(np.max(np.abs(w - old[path]))) / 127
            tipped = err > tol
            assert tipped.mean() <= 0.01, (what, name, int(tipped.sum()))
            tol += step * (1 + 1e-3)
        assert float(np.max(err)) <= tol, (what, name, float(np.max(err)), tol)


def one_sgd_step_matches(ref):
    arch, jmodel, params, tree, batches = ref
    jstep = jax.jit(jts.make_train_step(jmodel, jopt.sgd(lr=SGD_LR), jts.TrainStepConfig()))
    p1, _, jm = jstep(params, jopt.sgd(lr=SGD_LR).init(params), _jbatch(batches[0]))

    model = _port(arch, tree)
    opt = topt.sgd(lr=SGD_LR)
    state, m = tts.make_train_step(model, opt)(tts.init_opt_state(model, opt), batches[0])
    assert sorted(m) == sorted(jm) == ["aux", "ce", "grad_norm", "loss", "tokens"]
    for key in ("loss", "ce", "aux", "grad_norm"):
        _assert_rel(m[key], jm[key], f"{arch} {key}")
    targets = batches[0]["tokens"][:, 1:]
    counted = (targets >= 0) & (np.arange(S - 1) >= get_arch(arch, reduced=True).n_image_embeds)
    assert float(m["tokens"]) == float(jm["tokens"]) == counted.sum()
    assert int(state.step) == 1 and state.inner is None
    _assert_leaves(model, p1, f"{arch} after one SGD step")


def three_steps_of_the_arch_optimizer_match(ref):
    arch, jmodel, params, tree, batches = ref
    cfg = get_arch(arch, reduced=True)
    jo = jts.make_optimizer(cfg.optimizer, 1e-3)
    jstep = jax.jit(jts.make_train_step(jmodel, jo, jts.TrainStepConfig()))
    model = _port(arch, tree)
    to = tts.make_optimizer(cfg.optimizer, 1e-3)
    step = tts.make_train_step(model, to)
    jp, js, state = params, jo.init(params), tts.init_opt_state(model, to)
    for i, batch in enumerate(batches):
        jp, js, jm = jstep(jp, js, _jbatch(batch))
        state, m = step(state, batch)
        _assert_rel(m["loss"], jm["loss"], f"{arch} {cfg.optimizer} step {i} loss")
    assert int(state.step) == int(js.step) == 3


def test_one_sgd_step_matches(ref):
    one_sgd_step_matches(ref)


def test_three_steps_of_the_arch_optimizer_match(ref):
    three_steps_of_the_arch_optimizer_match(ref)


@pytest.mark.parametrize("accum,compression", [(4, None), (1, "int8"), (1, "topk")])
def test_accumulation_and_compression_match(accum, compression):
    _, jmodel, params, tree, batches = reference("internlm2-1.8b")
    batch = batches[0]
    jcfg = jts.TrainStepConfig(accum_steps=accum, compression=compression)
    jstep = jax.jit(jts.make_train_step(jmodel, jopt.sgd(lr=SGD_LR), jcfg))
    p1, _, jm = jstep(params, jopt.sgd(lr=SGD_LR).init(params), _jbatch(batch))

    model = _port("internlm2-1.8b", tree)
    opt = topt.sgd(lr=SGD_LR)
    step = tts.make_train_step(model, opt, tts.TrainStepConfig(accum_steps=accum,
                                                               compression=compression))
    _, m = step(tts.init_opt_state(model, opt), batch)
    assert sorted(m) == sorted(jm)
    for key in m:
        _assert_rel(m[key], jm[key], f"accum {accum} {compression} {key}")
    _assert_leaves(model, p1, f"accum {accum} compression {compression}",
                   tree if compression == "int8" else None)
