"""The port's train step against the reference's for the MoE and
encoder-decoder archs at their reduced configurations (f32): the checks of
``test_torch_train_step.py`` (one SGD step: metrics within 1e-5 relative,
every leaf within 1e-5 of its largest entry; three steps of the arch's own
optimizer: losses within 1e-5 relative), and the eval step on whisper-tiny.
"""
import jax
import pytest

from repro.training import train_step as jts
from repro_torch.training import train_step as tts
from test_torch_train_step import (
    _assert_rel, _jbatch, _port, one_sgd_step_matches, one_torch_thread, reference,
    three_steps_of_the_arch_optimizer_match,
)

MIXERS = ("grok-1-314b", "qwen2-moe-a2.7b", "whisper-tiny")


@pytest.fixture(scope="module", params=MIXERS)
def ref(request):
    return reference(request.param)


def test_one_sgd_step_matches(ref):
    one_sgd_step_matches(ref)


def test_three_steps_of_the_arch_optimizer_match(ref):
    three_steps_of_the_arch_optimizer_match(ref)


def test_eval_step_matches():
    _, jmodel, params, tree, batches = reference("whisper-tiny")  # the fixture's
    batch = batches[0]
    want = jax.jit(jts.make_eval_step(jmodel))(params, _jbatch(batch))
    model = _port("whisper-tiny", tree)
    got = tts.make_eval_step(model)(batch)
    assert sorted(got) == sorted(want)
    for key in got:
        _assert_rel(got[key], want[key], f"eval {key}")
    assert not any(p.requires_grad for p in model.parameters())  # inference stays frozen
