"""GPipe over worker processes on the PyTorch port
(``repro_torch.training.pipeline``) on the CPU, where CPU workers stand in
for the reference's forced host devices.

- in a subprocess with 4 forced host devices, the reference's
  ``pipeline_forward`` runs ``test_pipeline_parallel_matches_sequential``'s
  toy (L 8, D 16, 4 stages, 6 x 3 microbatches, ``tanh(x @ w)``) and the
  reduced ``internlm2-1.8b`` trunk at 4 layers (``block_apply`` of its dense
  stage) over 2 and 4 stages, beside this file's other cases;
- the port at the same stage counts: the toy within ``atol=1e-6`` (the
  reference's own bound), the trunk within ``TRUNK_TOL`` (1e-4: the port's
  f32 model tolerance, ``tests/test_torch_dense_archs.py``'s, where the two
  frameworks differ only in summation order) on the reference's parameters,
  and both bit for bit the port's own run of the same layers in this
  process one microbatch at a time (every matmul of the same shape, this
  process on one intra-op thread, as the workers are);
- ``split_stages`` is the reference's, placed stages are reused and refused
  on another mesh, ``Resident.call_each`` sends each worker its own
  arguments, a lambda stage is refused before a worker starts, a worker's
  exception raises in the parent, and the default device is ``cuda``.
"""
import functools
import textwrap
import threading

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.configs import get_arch
from repro_torch.core import shard
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.convert import params_from_arrays
from repro_torch.training import pipeline as tp

CPU = "cpu"
L, D, N_MICRO, MB = 8, 16, 6, 3  # the toy: test_pipeline_parallel_matches_sequential's
TRUNK_LAYERS, TRUNK_MICRO, TRUNK_MB, TRUNK_S = 4, 4, 2, 16
TRUNK_STAGES = (2, 4)
TRUNK_TOL = dict(atol=1e-4, rtol=1e-4)

# the reference's pipeline_forward on the toy and the reduced trunk, on 4
# forced host devices; the outputs saved to __PATH__
REFERENCE_RUN = textwrap.dedent(
    """
    import jax, jax.numpy as jnp, numpy as np
    assert jax.device_count() == 4
    from repro.configs import get_arch
    from repro.models import build_model
    from repro.models.transformer import block_apply
    from repro.training.pipeline import make_stage_fn, pipeline_forward, split_stages

    out = {{}}
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=({L}, {D}, {D})) * 0.1, jnp.float32)
    x = jnp.asarray(rng.normal(size=({N_MICRO}, {MB}, {D})), jnp.float32)
    mesh = jax.make_mesh((4, 1), ("pod", "data"))
    out["toy"] = pipeline_forward(make_stage_fn(lambda lp, h: jnp.tanh(h @ lp)),
                                  split_stages(w, 4), x, mesh=mesh, axis="pod")
    cfg = get_arch("internlm2-1.8b", reduced=True).replace(n_layers={TRUNK_LAYERS})
    stack = build_model(cfg).init(jax.random.PRNGKey(0))["stages"][0]
    xs = jnp.asarray(np.random.default_rng(1).normal(
        size=({TRUNK_MICRO}, {TRUNK_MB}, {TRUNK_S}, cfg.d_model)), jnp.float32)
    positions = jnp.arange({TRUNK_S})
    block = lambda lp, h: block_apply(lp, h, cfg, "dense", positions, {{}})[0]
    for n in {TRUNK_STAGES}:
        mesh = jax.make_mesh((n, 4 // n), ("pod", "data"))
        out[f"trunk{{n}}"] = pipeline_forward(make_stage_fn(block), split_stages(stack, n),
                                              xs, mesh=mesh, axis="pod")
    np.savez("__PATH__", **{{k: np.asarray(v) for k, v in out.items()}})
    print("OK")
    """
).format(L=L, D=D, N_MICRO=N_MICRO, MB=MB, TRUNK_LAYERS=TRUNK_LAYERS,
         TRUNK_MICRO=TRUNK_MICRO, TRUNK_MB=TRUNK_MB, TRUNK_S=TRUNK_S,
         TRUNK_STAGES=TRUNK_STAGES)


def toy_block(lp, x):
    return torch.tanh(x @ lp)


def failing_block(lp, x):
    raise ArithmeticError("a stage failed in its worker")


def _double(state, k):
    return state * k


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess starts with the module and runs beside
    its other cases; the four CPU workers start with it. This process runs
    on one intra-op thread, as the workers do."""
    path = tmp_path_factory.mktemp("pipeline") / "reference.npz"
    n = torch.get_num_threads()
    warm = [shard.mesh(4, CPU).submit(d, int, 0) for d in range(4)]
    out = {}

    def run():
        try:
            run_subprocess(REFERENCE_RUN.replace("__PATH__", str(path)), n_devices=4,
                           timeout=300)
            out["arrays"] = dict(np.load(path))
        except AssertionError as e:
            out["error"] = str(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    torch.set_num_threads(1)
    for c in warm:
        c.result()
    yield t, out
    t.join(timeout=300)
    torch.set_num_threads(n)


def _reference(reference_run, key):
    t, out = reference_run
    t.join(timeout=300)
    assert not t.is_alive(), "the reference's subprocess did not finish"
    assert "error" not in out, out.get("error")
    return torch.from_numpy(out["arrays"][key])


def _toy():
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=(L, D, D)) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(N_MICRO, MB, D)).astype(np.float32))
    return w, x


@pytest.fixture(scope="module")
def trunk():
    """The reduced internlm2-1.8b at 4 layers on the reference's parameters
    (``convert.params_from_arrays``): (config, the stacked blocks, the
    microbatched input)."""
    import jax

    from repro.configs import get_arch as jget_arch
    from repro.models import build_model as jbuild

    cfg = get_arch("internlm2-1.8b", reduced=True).replace(n_layers=TRUNK_LAYERS)
    params = jbuild(jget_arch("internlm2-1.8b", reduced=True).replace(
        n_layers=TRUNK_LAYERS)).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    model = params_from_arrays(cfg, tree, device=CPU)
    xs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(TRUNK_MICRO, TRUNK_MB, TRUNK_S, cfg.d_model)).astype(np.float32))
    return cfg, tp.stack_blocks(model.blocks), xs, model


def _sequential(stage_fn, stages, xs, n_stages):
    """The same layers in this process, one microbatch at a time."""
    outs = []
    for m in range(xs.shape[0]):
        h = xs[m]
        for r in range(n_stages):
            h = stage_fn(shard.tree_map(lambda a: a[r], stages), h)
        outs.append(h)
    return torch.stack(outs)


# --------------------------------------------------------------------------
# the toy and the trunk against the reference and the sequential run
# --------------------------------------------------------------------------

def test_split_stages_is_the_references():
    import jax.numpy as jnp

    from repro.training.pipeline import split_stages as jsplit

    w, _ = _toy()
    tree = {"w": w, "pair": (w[:, 0], w[:, :2])}
    got = tp.split_stages(tree, 4)
    want = jsplit({"w": jnp.asarray(w.numpy()), "pair": (jnp.asarray(w[:, 0].numpy()),
                                                          jnp.asarray(w[:, :2].numpy()))}, 4)
    assert got["w"].shape == (4, 2, D, D) and got["w"].data_ptr() == w.data_ptr()
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    for a, b in zip(got["pair"], want["pair"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(AssertionError):
        tp.split_stages(w, 3)


def test_toy_pipeline_equals_the_reference_and_the_sequential_run(reference_run):
    w, x = _toy()
    stage_fn = tp.make_stage_fn(toy_block)
    out = tp.pipeline_forward(stage_fn, tp.split_stages(w, 4), x,
                              mesh=tp.stage_mesh(4, CPU), axis="pod")
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.equal(out, _sequential(stage_fn, tp.split_stages(w, 4), x, 4))
    ref = x
    for i in range(L):
        ref = torch.tanh(ref @ w[i])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.numpy(), _reference(reference_run, "toy").numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("n_stages", TRUNK_STAGES)
def test_trunk_equals_the_reference_and_its_sequential_run(reference_run, trunk, n_stages):
    cfg, stack, xs, _ = trunk
    stage_fn = tp.make_stage_fn(functools.partial(tp.dense_block_apply, cfg, None, "auto"))
    stages = tp.split_stages(stack, n_stages)
    fa.reset_launches()
    out = tp.pipeline_forward(stage_fn, stages, xs, mesh=tp.stage_mesh(n_stages, CPU))
    assert fa.LAUNCHES["flash_attention"] == 0  # the CPU takes the plain route
    assert out.shape == xs.shape
    assert torch.equal(out, _sequential(stage_fn, stages, xs, n_stages))
    torch.testing.assert_close(out, _reference(reference_run, f"trunk{n_stages}"),
                               **TRUNK_TOL)


def test_dense_block_apply_is_the_block_forward(trunk):
    cfg, stack, xs, model = trunk
    for i, block in enumerate(model.blocks):
        lp = {k: v[i] for k, v in stack.items()}
        want = block(xs[0], torch.arange(TRUNK_S))
        assert torch.equal(tp.dense_block_apply(cfg, None, "auto", lp, xs[0]), want)
        assert torch.equal(tp.dense_block_apply(cfg, torch.arange(TRUNK_S), "naive", lp,
                                                xs[0]), block(xs[0], torch.arange(TRUNK_S),
                                                              attn_impl="naive"))


def test_stack_blocks_copies_each_layer(trunk):
    _, stack, _, model = trunk
    names = dict(model.blocks[0].named_parameters())
    assert set(stack) == set(names)
    for name, stacked in stack.items():
        assert stacked.shape == (TRUNK_LAYERS, *names[name].shape)
        for i, block in enumerate(model.blocks):
            assert torch.equal(stacked[i], dict(block.named_parameters())[name])


# --------------------------------------------------------------------------
# placement, the workers and refusals
# --------------------------------------------------------------------------

def test_placed_stages_are_reused_and_refused_on_another_mesh():
    w, x = _toy()
    stage_fn = tp.make_stage_fn(toy_block)
    mesh = tp.stage_mesh(2, CPU)
    placed = tp.place_stages(tp.split_stages(w, 2), mesh)
    try:
        a = tp.pipeline_forward(stage_fn, placed, x, mesh=mesh)
        b = tp.pipeline_forward(stage_fn, placed, x[:2], mesh=mesh)
        assert torch.equal(b, a[:2])  # the workers' stages outlive a call
        assert torch.equal(a, _sequential(stage_fn, tp.split_stages(w, 2), x, 2))
        with pytest.raises(ValueError, match="placed on another mesh"):
            tp.pipeline_forward(stage_fn, placed, x, mesh=tp.stage_mesh(4, CPU))
    finally:
        placed.close()
    with pytest.raises(ValueError, match="lead with the 2 stages"):
        tp.place_stages(tp.split_stages(w, 4), mesh)


def test_call_each_sends_each_worker_its_own_arguments():
    mesh = shard.mesh(3, CPU)
    res = mesh.resident(torch.ones, [(2,), (3,), (4,)])
    try:
        got = res.call_each(_double, [(torch.tensor(2.0),), None, (torch.tensor(5.0),)])
        assert got[1] is None
        assert torch.equal(got[0], torch.full((2,), 2.0))
        assert torch.equal(got[2], torch.full((4,), 5.0))
        with pytest.raises(ValueError, match="2 argument tuples for 3 workers"):
            res.call_each(_double, [(1,), (1,)])
    finally:
        res.close()


def test_a_tensor_crosses_as_its_storage_and_view():
    """What a stage's weights and activations go through: the bytes once a
    storage, every view's layout, and torch's own reduction for tensors
    that carry autograd state."""
    import pickle

    base = torch.arange(10.0).reshape(2, 5)
    tree = {"wide": base[None].expand(3, 2, 5), "same": [base, base[1]],
            "bf16": torch.ones(3, dtype=torch.bfloat16), "empty": torch.empty(0, 4),
            "param": torch.nn.Parameter(torch.ones(2)),
            "grad": torch.ones(2, requires_grad=True)}
    got = pickle.loads(shard.dumps(tree))
    assert got["wide"].stride() == (0, 5, 1) and torch.equal(got["wide"], tree["wide"])
    a, b = got["same"]
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    assert b.storage_offset() == 5 and torch.equal(b, base[1])
    assert got["bf16"].dtype == torch.bfloat16 and got["empty"].shape == (0, 4)
    assert type(got["param"]) is torch.nn.Parameter and got["grad"].requires_grad
    blob = shard.dumps(base[:1])  # a view carries its whole storage
    assert len(blob) >= base.numel() * 4


def test_large_storages_cross_through_a_file_removed_once_read():
    """A stage's weights and a hop's activation bypass the executor's pipe:
    storages of ``SPILL_BYTES`` or more go through a temporary file, the
    rest stay in the stream."""
    import os

    big = torch.arange(shard.SPILL_BYTES // 4 + 3, dtype=torch.float32)
    small = torch.arange(5)
    packed = shard._pack({"big": big, "view": big[2:7], "small": small}, "a test tree")
    assert packed.path is not None and os.path.exists(packed.path)
    assert packed.sizes == (big.numel() * 4,) and len(packed.stream) < shard.SPILL_BYTES
    got = shard._unpack(packed)
    assert not os.path.exists(packed.path)
    assert torch.equal(got["big"], big) and torch.equal(got["small"], small)
    assert got["view"].untyped_storage().data_ptr() == got["big"].untyped_storage().data_ptr()
    assert shard._pack(small, "a small tensor").path is None
    # through a worker and back: the argument's file and the result's
    assert torch.equal(shard.mesh(1, CPU).submit(0, torch.neg, big).result(), -big)


def test_a_lambda_stage_is_refused_before_a_worker_starts(monkeypatch):
    w, x = _toy()
    monkeypatch.setattr(tp, "place_stages", None)  # nothing may be placed
    with pytest.raises(ValueError, match="the stage function does not pickle"):
        tp.pipeline_forward(tp.make_stage_fn(lambda lp, h: h), tp.split_stages(w, 2), x,
                            mesh=tp.stage_mesh(2, CPU))


def test_a_workers_exception_raises_in_the_parent():
    w, x = _toy()
    with pytest.raises(ArithmeticError, match="a stage failed in its worker") as e:
        tp.pipeline_forward(tp.make_stage_fn(failing_block), tp.split_stages(w, 2), x,
                            mesh=tp.stage_mesh(2, CPU))
    assert "Traceback" in str(e.value.__cause__)  # the worker's traceback
    # the workers serve the next call
    out = tp.pipeline_forward(tp.make_stage_fn(toy_block), tp.split_stages(w, 2), x,
                              mesh=tp.stage_mesh(2, CPU))
    assert out.shape == x.shape


def test_the_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.stage_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.place_stages(tp.split_stages(_toy()[0], 2), shard.Mesh("cuda", [0, 0]))
