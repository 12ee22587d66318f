"""Block programs with zamba2's and the xLSTM's stages in the PyTorch port
against the JAX model API: ``(("zamba_super", 1), ("dense", 1))`` and
``(("mamba2", 2), ("dense", 1))`` on ``zamba2-2.7b``, ``(("mlstm", 2),)``,
``(("slstm", 1),)`` and ``(("mlstm", 1), ("slstm", 1), ("xlstm_pair",
1))`` on ``xlstm-350m``, each through the checks and at the tolerances of
``test_torch_mixed_programs.py``; and, on mixed programs, AdamW with
accumulation and top-k compression against the reference's steps and a
checkpoint of the port's parameters restored by the reference's
``Checkpointer``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.models.convert import leaves_to_tree, params_from_arrays, reference_leaves
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from test_torch_mixed_programs import (
    CHECKS, HERE, IDS, PROGRAMS, _assert_rel, _configs, _tree_np, one_torch_thread, port,
    reference,
)

RECURRENT = tuple(i for i in range(len(PROGRAMS)) if i not in HERE)


@pytest.mark.parametrize("check", CHECKS, ids=[c.__name__ for c in CHECKS])
@pytest.mark.parametrize("i", RECURRENT, ids=[IDS[i] for i in RECURRENT])
def test_program(i, check):
    check(i)


def test_adamw_with_accumulation_and_compression():
    """The optimizer, accumulation and top-k compression run on a mixed
    program's leaves with no change of their own: two AdamW steps' losses
    match the reference's."""
    i = 4  # zamba_super + dense: the shared block's leaves beside two stages
    r = reference(i)
    jmodel = r["jmodel"]
    cfg = jts.TrainStepConfig(accum_steps=2, compression="topk")
    jo = jopt.adamw(lr=1e-3, b2=0.95, weight_decay=0.1)
    jstep = jax.jit(jts.make_train_step(jmodel, jo, cfg))
    model = params_from_arrays(_configs(i)[0], r["tree"], "cpu")
    to = topt.adamw(lr=1e-3, b2=0.95, weight_decay=0.1)
    step = tts.make_train_step(model, to, tts.TrainStepConfig(accum_steps=2,
                                                              compression="topk"))
    jp, js, state = r["params"], jo.init(r["params"]), tts.init_opt_state(model, to)
    for k in range(2):
        batch = np.roll(r["batch"], k, axis=1)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(batch)})
        state, m = step(state, {"tokens": batch})
        _assert_rel(m["loss"], jm["loss"], f"AdamW step {k} loss")


def test_checkpoint_restores_in_the_reference(tmp_path):
    i = 4  # zamba_super + dense: the shared block beside two stages
    model = port(i)
    leaves = reference_leaves(model)
    tree = leaves_to_tree(leaves, [leaf.stack() for leaf in leaves])
    tckpt.Checkpointer(str(tmp_path)).save(3, {"params": tree})
    step, restored = jckpt.Checkpointer(str(tmp_path)).restore({"params": reference(i)["params"]})
    assert step == 3
    want = jax.tree_util.tree_flatten_with_path(reference(i)["tree"])[0]
    got = jax.tree_util.tree_flatten_with_path(_tree_np(restored["params"]))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
