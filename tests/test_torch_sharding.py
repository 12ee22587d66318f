"""The port's partition rules (``repro_torch.models.sharding``) against the
reference's ``models/sharding.py`` on a stand-in mesh (``AbstractMesh``:
sizes only, so no 256 devices are needed):

* ``param_spec`` of every reference leaf of every arch's full config (the
  model built on the meta device) and of its reduced config, and under
  ``fsdp`` and the ``fsdp_sp`` layout, at the meshes (16, 16), (2, 16, 16),
  (1, 8) and (4, 2);
* ``batch_shardings`` of every arch's train and prefill batch and
  ``cache_shardings`` of every decode cache (the port's shapes and the
  reference's own), at the reference's shape sets;
* ``sharded_bytes`` against the reference dry run's ``_sharded_bytes``;
* ``shard_of`` and ``unshard`` are inverse, and ``mesh_coords`` is
  ``jax.make_mesh``'s row-major order.

A spec entry of one axis in a tuple is compared as that axis (JAX's
``PartitionSpec`` writes ``("data",)`` as ``"data"``).
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as jget_arch
from repro.launch import shapes as jshapes
from repro.models import build_model as jbuild
from repro.models import sharding as jsharding
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import shapes
from repro_torch.models import build_model
from repro_torch.models import sharding
from repro_torch.models.convert import reference_leaves

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 8}, {"data": 4, "model": 2}]
VARIANTS = {"as is": {}, "fsdp": {"fsdp": True}, "fsdp_sp": {"sharding_mode": "fsdp_sp"}}


def _abstract(mesh):
    return AbstractMesh(tuple(mesh.values()), tuple(mesh))


def _norm(spec):
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)


def _ref_sharded_bytes():
    """The reference dry run's ``_sharded_bytes``; its module sets
    ``XLA_FLAGS`` at import, which is put back at once."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")._sharded_bytes
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_spec_is_the_references_on_every_leaf(arch, reduced):
    leaves = reference_leaves(build_model(get_arch(arch, reduced=reduced), "meta"))
    for variant, over in VARIANTS.items():
        cfg = get_arch(arch, reduced=reduced).replace(**over)
        jcfg = jget_arch(arch, reduced=reduced).replace(**over)
        for mesh in MESHES:
            ours = sharding.params_specs(cfg, mesh, leaves)
            for leaf, spec in zip(leaves, ours):
                want = jsharding.param_spec(jcfg, _abstract(mesh), sharding.leaf_path(leaf),
                                            leaf.shape)
                assert isinstance(spec, sharding.P)
                assert _norm(spec) == _norm(want), (variant, mesh, leaf.name, spec, want)


def _sds(x):
    return jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32)


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_shardings_are_the_references(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    jmodel = jbuild(jcfg)
    with shapes.fake_mode():
        model = shapes.fake_model(cfg)
        inputs = {name: shapes.batch_specs(cfg, spec) if spec.kind != "decode"
                  else shapes.decode_specs(cfg, model, spec)[1]
                  for name, spec in shapes.SHAPE_SETS.items()}
    jcaches = {name: jshapes.decode_specs(jcfg, jmodel, spec)[1]
               for name, spec in shapes.SHAPE_SETS.items() if spec.kind == "decode"}
    for mesh in MESHES:
        am = _abstract(mesh)
        for name, spec in shapes.SHAPE_SETS.items():
            if spec.kind != "decode":
                batch = inputs[name]
                for seq_over_model in (False, True):
                    ours = sharding.batch_shardings(mesh, batch, spec.batch, seq_over_model)
                    want = jsharding.batch_shardings(
                        am, {k: _sds(v) for k, v in batch.items()}, spec.batch, seq_over_model)
                    assert {k: _norm(v) for k, v in ours.items()} == {
                        k: _norm(v.spec) for k, v in want.items()}, (mesh, name)
                continue
            # the port's cache, through both rules
            cache = inputs[name]
            ours = sharding.cache_shardings(cfg, mesh, cache, spec.batch, spec.seq)
            leaves = [x for x in torch.utils._pytree.tree_leaves(cache)
                      if isinstance(x, torch.Tensor)]
            got = [s for s in torch.utils._pytree.tree_leaves(ours) if isinstance(s, sharding.P)]
            want = jsharding.cache_shardings(jcfg, am, [_sds(x) for x in leaves], spec.batch,
                                             spec.seq)
            assert [_norm(s) for s in got] == [_norm(w.spec) for w in want], (mesh, name)
            # the reference's own cache, through both rules
            jleaves = jax.tree_util.tree_leaves(jcaches[name])
            with torch.device("meta"):
                metas = [torch.empty(x.shape) for x in jleaves]
            ours = sharding.cache_shardings(cfg, mesh, metas, spec.batch, spec.seq)
            want = jsharding.cache_shardings(jcfg, am, jcaches[name], spec.batch, spec.seq)
            assert [_norm(s) for s in ours] == [
                _norm(w.spec) for w in jax.tree_util.tree_leaves(want)], (mesh, name)


def test_replicated_and_batch_spec():
    mesh = {"pod": 2, "data": 16, "model": 16}
    tree = {"a": torch.zeros(2, 3), "b": (torch.zeros(4), None)}
    assert sharding.replicated(mesh, tree) == {"a": sharding.P(), "b": (sharding.P(), None)}
    for ndim, seq in ((2, None), (3, 1)):
        assert _norm(sharding.batch_spec(mesh, ndim, seq)) == _norm(
            jsharding.batch_spec(_abstract(mesh), ndim, seq))
    assert sharding.data_axes(mesh) == jsharding.data_axes(_abstract(mesh)) == ("pod", "data")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "grok-1-314b", "zamba2-2.7b"])
def test_sharded_bytes_are_the_references(arch):
    ref = _ref_sharded_bytes()
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    leaves = reference_leaves(build_model(cfg, "meta"))
    dtypes = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    for mesh in MESHES + [{"data": 3, "model": 5}]:
        am = _abstract(mesh)
        with torch.device("meta"):
            metas = [torch.empty(leaf.shape, dtype=leaf.tensors[0].dtype) for leaf in leaves]
        specs = sharding.params_specs(cfg, mesh, leaves)
        jmetas = [jax.ShapeDtypeStruct(leaf.shape, dtypes[leaf.tensors[0].dtype])
                    for leaf in leaves]
        jspecs = [jax.sharding.NamedSharding(am, jsharding.param_spec(
            jcfg, am, sharding.leaf_path(leaf), leaf.shape)) for leaf in leaves]
        assert sharding.sharded_bytes(metas, specs, mesh) == ref(jmetas, jspecs, am)
        # a batch of odd size: the reference counts an undivided dim whole
        batch = {"tokens": torch.empty((6, 8), dtype=torch.int32, device="meta")}
        bs = sharding.batch_shardings(mesh, batch, 6)
        jb = jsharding.batch_shardings(am, {"tokens": jax.ShapeDtypeStruct((6, 8), jnp.int32)}, 6)
        assert sharding.sharded_bytes(batch, bs, mesh) == ref(
            {"tokens": jax.ShapeDtypeStruct((6, 8), jnp.int32)}, jb, am)


def test_mesh_coords_are_make_mesh_order():
    mesh = {"pod": 2, "data": 3, "model": 4}
    ids = np.arange(24).reshape(2, 3, 4)
    for r in range(24):
        c = sharding.mesh_coords(mesh, r)
        assert ids[c["pod"], c["data"], c["model"]] == r
    with pytest.raises(ValueError, match="outside a mesh of 24"):
        sharding.mesh_coords(mesh, 24)


@pytest.mark.parametrize("spec", [sharding.P(), sharding.P(None, "model"),
                                  sharding.P("data", "model"), sharding.P(("pod", "data"), None),
                                  sharding.P(None, ("data", "model"))])
def test_shard_of_and_unshard_are_inverse(spec):
    mesh = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    blocks = {r: sharding.shard_of(x, spec, mesh, sharding.mesh_coords(mesh, r)).clone()
              for r in range(8)}
    assert torch.equal(sharding.unshard(blocks, spec, mesh), x)
    one = {r: b for r, b in blocks.items() if sharding.mesh_coords(mesh, r)["pod"] == 0}
    if "pod" not in str(spec):  # a block a pod coordinate is a copy
        assert torch.equal(sharding.unshard(one, spec, mesh), x)
    elif one:
        with pytest.raises(ValueError, match="missing"):
            sharding.unshard(one, spec, mesh)
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_of(torch.zeros(3, 3), sharding.P("model", None), mesh,
                          sharding.mesh_coords(mesh, 0))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b", "whisper-tiny"])
def test_params_shardings_maps_the_reference_tree(arch):
    """``params_shardings`` over a whole reference parameter tree (here the
    reference's own, from ``jax.eval_shape``) gives each leaf its spec."""
    from repro_torch.models.convert import tree_values

    cfg, jcfg = get_arch(arch, reduced=True), jget_arch(arch, reduced=True)
    shapes_tree = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    leaves = reference_leaves(build_model(cfg, "meta"))
    for mesh in MESHES:
        ours = sharding.params_shardings(cfg, mesh, shapes_tree)
        want = jsharding.params_shardings(jcfg, _abstract(mesh), shapes_tree)
        for leaf, a, b in zip(leaves, tree_values(leaves, ours), tree_values(leaves, want)):
            assert _norm(a) == _norm(b.spec), (mesh, leaf.name)


def test_the_dry_run_counts_bytes_per_card_on_a_mesh(tmp_path, capsys):
    """``lower_cell(..., mesh_shape=)`` and ``--mesh``: the arguments' bytes
    per card under these specs; ``--mesh 1`` keeps the one-card record."""
    from repro_torch.launch import dryrun, mesh as tmesh

    one = dryrun.lower_cell("whisper-tiny", "decode_32k")
    unit = dryrun.lower_cell("whisper-tiny", "decode_32k", mesh_shape={"data": 1, "model": 1})
    node = dryrun.lower_cell("whisper-tiny", "decode_32k", mesh_shape={"data": 2, "model": 4})
    assert "fits_per_card" not in one and one["mesh"] == "1xH100" and one["n_devices"] == 1
    assert unit["args_bytes_per_device"] == unit["args_bytes_one_card"] == one[
        "args_bytes_per_device"]
    assert node["mesh"] == "2x4" and node["n_devices"] == 8 and node["fits_per_card"]
    assert node["args_bytes_one_card"] == one["args_bytes_per_device"]
    assert 0 < node["args_bytes_per_device"] < one["args_bytes_per_device"] / 2
    for k in ("flops_per_device", "hbm_bytes_per_device", "roofline"):
        assert node[k] == one[k]  # one card's counts
    assert node["collective_wire_bytes_per_device"] == 0 and "collective_note" in node
    # the per-card bytes, by hand: parameters, tokens and cache under their specs
    cfg = get_arch("whisper-tiny")
    m = {"data": 2, "model": 4}
    with shapes.fake_mode():
        model = shapes.fake_model(cfg)
        leaves = reference_leaves(model)
        tokens, cache, _ = shapes.decode_specs(cfg, model, shapes.SHAPE_SETS["decode_32k"])
        b, s = shapes.SHAPE_SETS["decode_32k"].batch, shapes.SHAPE_SETS["decode_32k"].seq
        want = (sharding.sharded_bytes([leaf.tensors[0].new_empty(leaf.shape) for leaf in leaves],
                                       sharding.params_specs(cfg, m, leaves), m)
                + sharding.sharded_bytes(tokens, sharding.batch_shardings(m, tokens, b), m)
                + sharding.sharded_bytes(cache, sharding.cache_shardings(cfg, m, cache, b, s), m))
    assert node["args_bytes_per_device"] == want
    assert tmesh.parse_mesh("1") == {"data": 1, "model": 1}
    assert tmesh.parse_mesh("2x16x16") == tmesh.parse_mesh("multi") == {
        "pod": 2, "data": 16, "model": 16}
    assert tmesh.parse_mesh("single") == {"data": 16, "model": 16}
    with pytest.raises(ValueError, match="DxM or PxDxM"):
        tmesh.parse_mesh("2x2x2x2")
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "16x16",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "fits per card" in out and "DRY-RUN SUMMARY: 1 ok" in out
    assert os.listdir(tmp_path) == ["whisper-tiny__decode_32k__16x16.json"]
