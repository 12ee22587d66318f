"""The PyTorch port's MoE layer and the two MoE archs — ``qwen2-moe-a2.7b``
(routed and shared experts) and ``grok-1-314b`` (routed only) — against the
JAX reference at their reduced configurations (f32), on the same
parameters.

The layer is held against ``repro.models.moe.moe_apply`` (``y`` and the aux
loss) at the default capacity, at ``capacity_factor=0.25``, where entries
are dropped (and the dropped entries are the ones the reference's per-row
sorted dispatch drops), at an ample capacity, where it also equals the
dense oracle ``moe_apply_reference``, and at S = 1 (decode's capacity of 1
an expert). The archs are held against the JAX model API: forward with its
aux loss, prefill and its caches, 8 int-position decode steps, ``[B]``
position decode row by row, the parameters and their count; the serve loop
with ``--per-slot-positions`` against each request's own greedy run.
Tolerances are ``tests/test_torch_dense_archs.py``'s: 1e-4 on logits, 1e-5
on the layer and the caches. Inputs come from numpy with a fixed seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.models import moe as JM
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_arrays

ARCHS = ("qwen2-moe-a2.7b", "grok-1-314b")
N_DECODE = 8
PROMPT, CACHE = 24, 40
TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
D, E, F_EXPERT, F_SHARED = 32, 8, 24, 48


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _tokens(b, s, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------- the layer

@pytest.fixture(scope="module", params=[0, 2], ids=["routed", "shared"])
def layer(request):
    """(the reference's MoE params, the port's :class:`MoE` on them)."""
    n_shared = request.param
    p = JM.moe_init(jax.random.PRNGKey(4), D, E, F_EXPERT, n_shared, F_SHARED, jnp.float32)
    moe = M.MoE(D, E, 2, F_EXPERT, n_shared, F_SHARED, 1.25, torch.float32)
    with torch.no_grad():
        for n in ("router", "w_gate", "w_up", "w_down"):
            getattr(moe, n).copy_(_t(p[n]))
        if n_shared:
            for n in ("w_gate", "w_up", "w_down"):
                getattr(moe.shared, n).weight.copy_(_t(p["shared"][n]).t())
            moe.shared_gate.copy_(_t(p["shared_gate"]))
    return p, moe


def _x(b, s, seed=5):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(np.float32)


def _kept_in_token_order(expert_ids, c):
    """The entries a per-row dispatch keeps, flat ``(token, choice)`` order:
    within each expert the first ``c`` in that order (an independent
    numpy count)."""
    b, s, k = expert_ids.shape
    keep = np.zeros((b, s * k), bool)
    for r in range(b):
        seen = {}
        for i, e in enumerate(expert_ids[r].reshape(-1)):
            keep[r, i] = seen.get(e, 0) < c
            seen[e] = seen.get(e, 0) + 1
    return keep


@pytest.mark.parametrize("cf,s", [(1.25, 24), (0.25, 24), (1.25, 1), (0.25, 1)],
                         ids=["default", "dropping", "decode", "decode-dropping"])
def test_moe_layer_matches_moe_apply(layer, cf, s):
    p, moe = layer
    moe.capacity_factor = cf
    x = _x(3, s)
    want, want_aux = JM.moe_apply(p, jnp.asarray(x), n_experts=E, top_k=2, capacity_factor=cf)
    with torch.no_grad():
        got, aux = moe(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **LAYER_TOL)
    # the entries kept are the reference's: the lowest (token, choice)
    # indices of each expert
    c = M.capacity(s, 2, E, cf)
    assert c == JM._capacity(s, 2, E, cf)
    _, _, ids = M.route(moe.router, _t(x), 2)
    order, keep, _ = M.dispatch(ids, E, c)
    keep_flat = torch.empty_like(keep).scatter_(-1, order, keep)
    np.testing.assert_array_equal(keep_flat.numpy(), _kept_in_token_order(ids.numpy(), c))
    if cf == 0.25 and s > 1:
        assert not keep.all()  # this case drops entries


def test_ample_capacity_equals_the_dense_oracle(layer):
    p, moe = layer
    moe.capacity_factor = float(E)  # every entry fits
    x = _x(2, 24, seed=6)
    want = JM.moe_apply_reference(p, jnp.asarray(x), n_experts=E, top_k=2)
    with torch.no_grad():
        got, _ = moe(_t(x))
        oracle = M.moe_reference(moe, _t(x))
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("s", [1, 16])
def test_aux_is_the_switch_loss_of_the_routing(layer, s):
    """The aux loss, f32, is E times the sum over experts of the share of
    top-k picks that go to the expert and its mean router probability,
    counted here in numpy from the router alone."""
    p, moe = layer
    moe.capacity_factor = 1.25
    x = _x(2, s, seed=7)
    with torch.no_grad():
        _, aux = moe(_t(x))
    logits = x.astype(np.float64) @ np.asarray(p["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    picks = np.argsort(-probs, axis=-1, kind="stable")[..., :moe.top_k]
    share = np.bincount(picks.ravel(), minlength=E) / picks.size
    want = E * float((share * probs.mean((0, 1))).sum())
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), want, **LAYER_TOL)


@pytest.mark.parametrize("s,k,e,cf", [(1, 4, 60, 1.25), (1024, 4, 60, 1.25), (24, 2, 8, 0.25),
                                      (7, 2, 4, 1.0), (1, 2, 8, 8.0), (1000, 2, 8, 1.25)])
def test_capacity_is_the_references(s, k, e, cf):
    assert M.capacity(s, k, e, cf) == JM._capacity(s, k, e, cf)


def test_rows_dispatch_alone():
    """A row's output is that row run alone (the dispatch never crosses
    rows), dropping included."""
    moe = M.MoE(D, E, 2, F_EXPERT, 0, 0, 0.25, torch.float32)
    moe.init(torch.Generator().manual_seed(1))
    x = _t(_x(3, 24, seed=8))
    with torch.no_grad():
        y, _ = moe(x)
        for r in range(3):
            alone, _ = moe(x[r:r + 1])
            torch.testing.assert_close(y[r:r + 1], alone, atol=1e-6, rtol=1e-6)


def test_init_keeps_the_router_f32_and_the_experts_in_the_model_dtype():
    cfg = get_arch("qwen2-moe-a2.7b", reduced=True).replace(dtype_name="bfloat16")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    moe = model.blocks[0].moe
    assert moe.router.dtype == torch.float32
    assert {moe.w_gate.dtype, moe.w_up.dtype, moe.w_down.dtype,
            moe.shared_gate.dtype} == {torch.bfloat16}
    assert moe.w_gate.shape == (cfg.n_experts, cfg.d_model, cfg.expert_d_ff)
    assert moe.w_down.shape == (cfg.n_experts, cfg.expert_d_ff, cfg.d_model)
    # scaled normal draws: std about 1/sqrt(D) in, 1/sqrt(F) out
    assert abs(float(moe.w_gate.float().std()) * cfg.d_model ** 0.5 - 1) < 0.1
    assert abs(float(moe.w_down.float().std()) * cfg.expert_d_ff ** 0.5 - 1) < 0.1


# ---------------------------------------------------------------- the archs

@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """(arch, JAX model, JAX params, the params as f32 numpy, the port's
    model on them)."""
    arch = request.param
    jmodel = jbuild(jget_arch(arch, reduced=True))
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = _tree_np(params)
    return arch, jmodel, params, tree, params_from_arrays(get_arch(arch, reduced=True), tree,
                                                          "cpu")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch, reduced):
    cfg, jcfg = get_arch(arch, reduced=reduced), jget_arch(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.block_program() == jcfg.block_program() == (("moe", cfg.n_layers),)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_variant_of_the_full_config(arch):
    cfg = get_arch(arch)
    assert fa.variant(cfg.dtype, cfg.hd) == "wgmma"
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == {
        "qwen2-moe-a2.7b": (16, 16, 128), "grok-1-314b": (48, 8, 128)}[arch]


def test_n_params_and_every_leaf(ref):
    arch, jmodel, params, tree, model = ref
    assert model.n_params() == jmodel.n_params(params)
    moe = tree["stages"][0]["moe"]
    for i, block in enumerate(model.blocks):
        for n in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(getattr(block.moe, n).numpy(), moe[n][i])
        if arch == "qwen2-moe-a2.7b":
            np.testing.assert_array_equal(block.moe.shared_gate.numpy(), moe["shared_gate"][i])
            for n in ("w_gate", "w_up", "w_down"):
                np.testing.assert_array_equal(getattr(block.moe.shared, n).weight.numpy().T,
                                              moe["shared"][n][i])
        else:
            assert block.moe.shared is None and "shared" not in moe


def test_params_from_arrays_refuses_a_stage_of_another_depth(ref):
    arch, _, _, tree, _ = ref
    short = dict(tree, stages=(jax.tree_util.tree_map(lambda a: a[:1], tree["stages"][0]),))
    with pytest.raises(ValueError, match="stages\\[0\\] holds 1 layers"):
        params_from_arrays(get_arch(arch, reduced=True), short, "cpu")


def test_forward_and_its_aux_match(ref):
    arch, jmodel, params, _, model = ref
    cfg = get_arch(arch, reduced=True)
    tokens = _tokens(2, 32, cfg.vocab_size)
    want, want_aux = jax.jit(jmodel.forward)(params, {"tokens": jnp.asarray(tokens)})
    got, aux = model(torch.from_numpy(tokens))
    assert got.shape == (2, 32, cfg.padded_vocab) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), **LAYER_TOL)


def test_prefill_and_int_position_decode_match(ref):
    arch, jmodel, params, _, model = ref
    cfg = get_arch(arch, reduced=True)
    tokens = _tokens(2, PROMPT, cfg.vocab_size)
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=CACHE))
    decode = jax.jit(jmodel.decode_step)
    want, jcache = prefill(params, jnp.asarray(tokens))
    got, cache = model.prefill(torch.from_numpy(tokens), cache_len=CACHE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    (jk, jv), = jcache
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jk), **LAYER_TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jv), **LAYER_TOL)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    for i in range(N_DECODE):
        want, jcache = decode(params, jnp.asarray(tok), jcache, jnp.asarray(PROMPT + i, jnp.int32))
        got, cache = model.decode_step(torch.from_numpy(tok).long(), cache, PROMPT + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(jnp.argmax(want[:, 0], -1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(got[:, 0].argmax(-1).numpy(), tok[:, 0])
    (jk, jv), = jcache
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jk), **LAYER_TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jv), **LAYER_TOL)


def test_row_position_decode_matches_each_row_alone(ref):
    """Prompts of 13 and 24 tokens, each prefilled alone into a 40-slot
    cache and inserted into a batch of 2; 8 steps at ``[B]`` positions, each
    row's logits against its own sequence decoded on the JAX model API."""
    arch, jmodel, params, _, model = ref
    cfg = get_arch(arch, reduced=True)
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=CACHE))
    decode = jax.jit(jmodel.decode_step)
    lengths = (13, PROMPT)
    cache = model.init_cache(len(lengths), CACHE)
    jcaches, toks = [], []
    for b, n in enumerate(lengths):
        prompt = _tokens(1, n, cfg.vocab_size, seed=10 + b)
        want, jc = prefill(params, jnp.asarray(prompt))
        got, small = model.prefill(torch.from_numpy(prompt), cache_len=CACHE)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        serve.insert_cache(cache, small, b)
        jcaches.append(jc)
        toks.append(int(jnp.argmax(want[0, -1])))
    pos = torch.tensor(lengths, dtype=torch.int64)
    for i in range(N_DECODE):
        got, cache = model.decode_step(torch.tensor(toks)[:, None], cache, pos + i)
        for b, n in enumerate(lengths):
            want, jcaches[b] = decode(params, jnp.asarray([[toks[b]]], jnp.int32), jcaches[b],
                                      jnp.asarray(n + i, jnp.int32))
            np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want), **TOL)
            toks[b] = int(jnp.argmax(want[0, 0]))
            assert int(got[b, 0].argmax()) == toks[b]


def test_serve_per_slot_positions_gives_every_request_its_own_tokens():
    """The reduced qwen2-moe served with ``--per-slot-positions``, 6
    requests on 2 slots: each request's tokens are its own greedy prefill +
    decode, alone."""
    arch, n_req, prompt_len, max_new, cache_len = "qwen2-moe-a2.7b", 6, 16, 6, 48
    stats = {}
    result = serve.main(["--arch", arch, "--reduced", "--requests", str(n_req), "--slots", "2",
                         "--prompt-len", str(prompt_len), "--max-new", str(max_new),
                         "--cache-len", str(cache_len), "--device", "cpu",
                         "--per-slot-positions"], stats=stats)
    assert (result["arch"], result["total_tokens"]) == (arch, n_req * max_new)
    model = build_model(get_arch(arch, reduced=True), "cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    for rid in range(n_req):
        prompt = rng.integers(0, model.config.vocab_size, size=prompt_len).astype(np.int32)
        logits, cache = model.prefill(torch.from_numpy(prompt[None]), cache_len=cache_len)
        toks = [int(logits[0, -1].argmax())]
        for i in range(max_new - 1):
            logits, cache = model.decode_step(torch.tensor([[toks[-1]]]), cache, prompt_len + i)
            toks.append(int(logits[0, -1].argmax()))
        assert stats["tokens"][rid] == toks, rid
