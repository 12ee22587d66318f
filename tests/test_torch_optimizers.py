"""The port's optimizers, schedule, clip and gradient compression
(``repro_torch.training.optimizer``, ``.compression``) against the
reference's, on one tree of seeded numpy leaves, and the reference-leaf
view (``models.convert.reference_leaves``) against the reference's
parameter trees.

The tree holds stacked leaves as LM training makes them: ``[L, D]`` gains
and ``[L, in, out]`` matrices over one port tensor a layer (the matrices
as ``nn.Linear`` weights ``[out, in]``), two leaves large enough for
Adafactor to factor, one under 1024 elements, and unstacked ones. The
port's side runs through ``RefLeaf``: stack, update, write back, stack
again, as the train step does. Each optimizer runs 5 steps on fixed seeded
gradients; the leaves agree to rtol 1e-6. Compression takes the same
inputs and agrees bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import build_model
from repro_torch.models.convert import (
    RefLeaf, leaves_to_tree, params_from_arrays, params_to_arrays, reference_leaves,
    tree_values,
)
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from test_torch_train_step import one_torch_thread  # noqa: F401 (a module fixture)

STEPS = 5
RTOL = 1e-6
# name: (reference shape, layers stacked, transposed)
LEAVES = {
    "emb": ((200, 130), 0, False),  # factored (both dims >= 128), unstacked
    "final_norm": ((48,), 0, False),  # 1-d: no decay
    "stages.ln1": ((3, 48), 3, False),  # stacked gains [L, D]: decayed, as the reference does
    "stages.w": ((3, 48, 40), 3, True),  # stacked [L, in, out] over [out, in] weights
    "stages.big": ((2, 128, 136), 2, True),  # stacked and factored
    "head": ((20, 30), 0, True),  # under 1024 elements: compression passes it
}


def _draw(seed):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=shape).astype(np.float32) for n, (shape, _, _) in LEAVES.items()}


def _nest(flat):
    """The reference's pytree of the flat names."""
    tree = {}
    for name, x in flat.items():
        node = tree
        *outer, last = name.split(".")
        for key in outer:
            node = node.setdefault(key, {})
        node[last] = x
    return tree


def _port_leaves(values):
    """RefLeafs over a port tensor a layer holding ``values``."""
    leaves = []
    for name, (shape, layers, tr) in LEAVES.items():
        one = shape[1:] if layers else shape
        t_shape = one[::-1] if tr else one
        tensors = tuple(torch.nn.Parameter(torch.zeros(t_shape), requires_grad=False)
                        for _ in range(max(layers, 1)))
        leaf = RefLeaf(tuple(name.split(".")), shape, tensors, tr)
        leaf.write(torch.from_numpy(values[name]))
        leaves.append(leaf)
    return leaves


def _flat(tree):
    """The reference tree's leaves in the order of ``LEAVES``."""
    return [tree[n] if "." not in n else tree["stages"][n.split(".")[1]] for n in LEAVES]


def _decay_w_only(params):  # a custom mask over the list (port) or the tree (reference)
    if isinstance(params, dict):
        return jax.tree_util.tree_map_with_path(
            lambda path, p: jax.tree_util.keystr(path).endswith("['w']"), params)
    return [n == "stages.w" for n in LEAVES]


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(lr=0.05),
    "sgd momentum": lambda m: m.sgd(lr=0.05, momentum=0.9),
    "adamw f32": lambda m: m.adamw(lr=1e-2, weight_decay=0.1),
    "adamw bf16 moments": lambda m: m.adamw(
        lr=1e-2, weight_decay=0.1,
        moment_dtype=jnp.bfloat16 if m is jopt else torch.bfloat16),
    "adamw mask": lambda m: m.adamw(lr=1e-2, weight_decay=0.1, mask=_decay_w_only),
    "adamw cosine": lambda m: m.adamw(lr=m.cosine_schedule(1e-2, 2, STEPS), weight_decay=0.1),
    "adafactor": lambda m: m.adafactor(lr=1e-2),
    "adafactor clip": lambda m: m.adafactor(lr=1e-2, clip_threshold=0.05),
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_the_reference_on_stacked_leaves(name):
    p0 = _draw(0)
    grads = [_draw(100 + i) for i in range(STEPS)]

    jo = OPTIMIZERS[name](jopt)
    jp = jax.tree_util.tree_map(jnp.asarray, _nest(p0))
    js = jo.init(jp)
    for g in grads:
        upd, js = jo.update(jax.tree_util.tree_map(jnp.asarray, _nest(g)), js, jp)
        jp = jopt.apply_updates(jp, upd)

    to = OPTIMIZERS[name](topt)
    leaves = _port_leaves(p0)
    ts = to.init([leaf.stack() for leaf in leaves])
    for g in grads:
        stacked = [leaf.stack() for leaf in leaves]
        upd, ts = to.update([torch.from_numpy(g[n]) for n in LEAVES], ts, stacked)
        for leaf, p in zip(leaves, topt.apply_updates(stacked, upd)):
            leaf.write(p)

    assert int(ts.step) == int(js.step) == STEPS
    for leaf, want in zip(leaves, _flat(jp)):
        np.testing.assert_allclose(leaf.stack().numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL * float(np.max(np.abs(want))), err_msg=leaf.name)
    if name.startswith("adafactor"):  # the factored leaves keep row and column statistics
        shapes = [tuple(v.shape) for v in ts.inner.vc]
        assert shapes[0] == (130,) and shapes[4] == (2, 136) and shapes[1] == ()
    if name == "adamw bf16 moments":
        assert all(m.dtype == torch.bfloat16 for m in ts.inner.mu + ts.inner.nu)
        for m, want in zip(ts.inner.mu, _flat(js.inner.mu)):
            np.testing.assert_array_equal(m.float().numpy(), np.asarray(want, np.float32))


def test_cosine_schedule_matches():
    jf = jopt.cosine_schedule(3e-4, 20, 100)
    tf = topt.cosine_schedule(3e-4, 20, 100)
    for step in (0, 1, 7, 19, 20, 21, 50, 99, 100, 130):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = float(tf(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-12), step


def test_clip_by_global_norm_matches():
    g = _draw(7)
    want, wn = jopt.clip_by_global_norm(_nest(g), 1.0)
    got, n = topt.clip_by_global_norm([torch.from_numpy(g[k]) for k in LEAVES], 1.0)
    assert float(n) == pytest.approx(float(wn), rel=RTOL)
    for x, w in zip(got, _flat(want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("name", ["int8", "topk"])
def test_compression_matches_bit_for_bit(name):
    g = _draw(11)
    want = _flat(jcomp.COMPRESSORS[name](jax.tree_util.tree_map(jnp.asarray, _nest(g))))
    got = tcomp.COMPRESSORS[name]([torch.from_numpy(g[k]) for k in LEAVES])
    for (key, x), w in zip(zip(LEAVES, got), want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w), err_msg=key)
    assert np.array_equal(got[-1].numpy(), g["head"])  # under 1024 elements: passed through
    q, s = tcomp.quantize_int8(torch.from_numpy(g["emb"]))
    jq, js = jcomp.quantize_int8(jnp.asarray(g["emb"]))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_error_feedback_matches():
    comp = functools.partial(jcomp.topk_compress, fraction=0.05)
    tcomp_k = functools.partial(tcomp.topk_compress, fraction=0.05)
    js = jcomp.error_feedback_init(_nest(_draw(0)))
    ts = tcomp.error_feedback_init([torch.from_numpy(v) for v in _draw(0).values()])
    for i in range(STEPS):
        g = _draw(200 + i)
        jsent, js = jcomp.error_feedback_apply(js, jax.tree_util.tree_map(jnp.asarray, _nest(g)),
                                               comp)
        sent, ts = tcomp.error_feedback_apply(ts, [torch.from_numpy(g[k]) for k in LEAVES],
                                              tcomp_k)
        for x, w in zip(sent, _flat(jsent)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(w))
        for x, w in zip(ts.residual, _flat(js.residual)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(w))


# ---------------------------------------------------------------- the leaf view

@pytest.mark.parametrize("arch", list_archs())
def test_reference_leaves_are_the_reference_tree_at_full_width(arch):
    """Every leaf's path, shape and dtype against the reference's full
    parameter tree (shapes only: the port's model on the meta device)."""
    cfg = get_arch(arch)
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jbuild(jget_arch(arch)).init, jax.random.PRNGKey(0)))[0]
    leaves = reference_leaves(build_model(cfg, "meta"))
    assert [leaf.path for leaf in leaves] == [
        tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path) for path, _ in want]
    for leaf, (_, w) in zip(leaves, want):
        assert leaf.shape == tuple(w.shape), leaf.name
        assert str(leaf.tensors[0].dtype).split(".")[1] == str(w.dtype), leaf.name


@pytest.mark.parametrize("arch", list_archs())
def test_params_to_arrays_inverts_params_from_arrays(arch):
    """On seeded values in the reference tree's shapes and dtypes (no
    gain at 1 or bias at 0 that a mixed-up leaf could hide behind)."""
    shapes = jax.eval_shape(jbuild(jget_arch(arch, reduced=True)).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tree = jax.tree_util.tree_map(
        lambda w: np.asarray(jnp.asarray(rng.standard_normal(w.shape), w.dtype), np.float32),
        shapes)
    back = params_to_arrays(params_from_arrays(get_arch(arch, reduced=True), tree, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_leaves_to_tree_and_back():
    model = build_model(get_arch("zamba2-2.7b", reduced=True), "cpu")
    leaves = reference_leaves(model)
    tree = leaves_to_tree(leaves, [leaf.name for leaf in leaves])
    assert isinstance(tree["stages"], tuple) and len(tree["stages"]) == 1
    assert tree["stages"][0]["mamba"]["mixer"]["A_log"] == "stages.0.mamba.mixer.A_log"
    assert tree["shared_attn"]["attn"]["wq"] == "shared_attn.attn.wq"
    assert tree_values(leaves, tree) == [leaf.name for leaf in leaves]
    with pytest.raises(ValueError, match="stages.0.mamba.ln: shape"):
        dataclasses.replace(leaves[[x.name for x in leaves].index("stages.0.mamba.ln")]
                            ).write(torch.zeros(3))
