"""The port's train step against the reference's for the recurrent
``xlstm-350m`` and the hybrid ``zamba2-2.7b`` at their reduced
configurations (f32), through the plain GLA scan: the checks of
``test_torch_train_step.py`` (one SGD step: metrics within 1e-5 relative,
every leaf within 1e-5 of its largest entry; three steps of the arch's own
optimizer: losses within 1e-5 relative), and remat, which changes no
number.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models.convert import params_from_arrays, params_to_arrays
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts
from test_torch_train_step import (
    SGD_LR, one_sgd_step_matches, one_torch_thread, reference,
    three_steps_of_the_arch_optimizer_match,
)

RECURRENT = ("xlstm-350m", "zamba2-2.7b")


@pytest.fixture(scope="module", params=RECURRENT)
def ref(request):
    return reference(request.param)


def test_one_sgd_step_matches(ref):
    one_sgd_step_matches(ref)


def test_three_steps_of_the_arch_optimizer_match(ref):
    three_steps_of_the_arch_optimizer_match(ref)


def test_training_leaves_the_routes_and_remat_numbers_alone():
    """The step's forward takes the plain routes and puts the model's back;
    remat changes no number (a step with ``remat=False`` gives the same
    loss, gradient norm and parameters bit for bit)."""
    _, _, _, tree, batches = reference("zamba2-2.7b")  # the fixture's, built once
    batch = batches[0]
    out = []
    for remat in (True, False):
        cfg = get_arch("zamba2-2.7b", reduced=True).replace(remat=remat)
        model = params_from_arrays(cfg, tree, "cpu")
        opt = topt.sgd(lr=SGD_LR)
        _, m = tts.make_train_step(model, opt)(tts.init_opt_state(model, opt), batch)
        assert (model.attn_impl, model.gla_impl) == ("auto", "auto")
        out.append((m, params_to_arrays(model)))
    (m1, p1), (m2, p2) = out
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(a, b)
