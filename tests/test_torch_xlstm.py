"""The PyTorch port's xLSTM (``xlstm-350m`` reduced: 2 mLSTM/sLSTM pairs, d
64, f32) against the JAX reference on the same parameters.

The reference's parameters come across with ``convert.params_from_arrays``;
inputs come from numpy with a fixed seed. The mixers agree to f32 rounding
(atol 2e-5); the model's logits to atol 1e-4 (the frameworks differ only in
summation order, which the recurrences carry across steps), with identical
greedy tokens, at a prompt length the chunk divides (32, the chunked
program) and one it does not (24, the sequential scan). The bf16 variant is
held at atol 0.1 on logits of magnitude ~1-5, as the dense model's is in
``tests/test_torch_lm.py``: a few bf16 ulps where the frameworks round at
different points.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.models import ssm as JS
from repro_torch.configs import get_arch
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import XLstmCache, build_model
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_arrays

ARCH = "xlstm-350m"
N_DECODE = 4


def _tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _tokens(b, s, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_model():
    """(cfg, JAX model, JAX params, the params as f32 numpy)."""
    cfg = jget_arch(ARCH, reduced=True)
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, _tree_np(params)


# ---------------------------------------------------------------- mixers

def _port_mlstm(p, dims):
    m = S.MLstm(S.MLstmDims(*dims), torch.float32)
    with torch.no_grad():
        for n in ("up_proj", "wq", "wk", "wv", "w_if", "down_proj"):
            getattr(m, n).weight.copy_(_t(p[n]).t())
        m.b_if.copy_(_t(p["b_if"]))
        m.norm_g.copy_(_t(p["norm_g"]))
    return m


def _port_slstm(p, dims):
    m = S.SLstm(S.SLstmDims(*dims), torch.float32)
    with torch.no_grad():
        for n in ("w_in", "out_proj"):
            getattr(m, n).weight.copy_(_t(p[n]).t())
        for n in ("r", "b", "norm_g"):
            getattr(m, n).copy_(_t(p[n]))
    return m


@pytest.mark.parametrize("s,chunk", [(32, 8), (20, 8)])
def test_mlstm_apply_and_decode_match(s, chunk):
    dims = JS.MLstmDims.make(32, 4, 2)
    p = JS.mlstm_init(jax.random.PRNGKey(1), dims, jnp.float32)
    m = _port_mlstm(p, dims)
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    hs, ns = JS.mlstm_state_shape(dims, 2)
    h0 = (rng.normal(size=hs) * 0.1).astype(np.float32)
    n0 = np.abs(rng.normal(size=ns)).astype(np.float32)
    want, (wh, wn) = JS.mlstm_apply(p, jnp.asarray(x), dims, (jnp.asarray(h0), jnp.asarray(n0)),
                                    chunk=chunk)
    with torch.no_grad():
        got, (gh, gn) = m(_t(x), (_t(h0), _t(n0)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=2e-5, rtol=2e-5)
    xt = rng.normal(size=(2, 32)).astype(np.float32)
    want, (wh2, wn2) = JS.mlstm_decode(p, jnp.asarray(xt), dims, (wh, wn))
    with torch.no_grad():
        got, (gh2, gn2) = m.decode(_t(xt), (gh, gn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(gh2.numpy(), np.asarray(wh2), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(gn2.numpy(), np.asarray(wn2), atol=2e-5, rtol=2e-5)


def test_slstm_apply_and_decode_match():
    dims = JS.SLstmDims.make(32, 4)
    p = JS.slstm_init(jax.random.PRNGKey(2), dims, jnp.float32)
    m = _port_slstm(p, dims)
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    want, wst = JS.slstm_apply(p, jnp.asarray(x), dims)
    with torch.no_grad():
        got, gst = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    for a, b in zip(gst, wst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=2e-5)
    xt = rng.normal(size=(2, 32)).astype(np.float32)
    want, wst = JS.slstm_decode(p, jnp.asarray(xt), dims, wst)
    with torch.no_grad():
        got, gst = m.decode(_t(xt), gst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    for a, b in zip(gst, wst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------- model

def test_params_from_arrays_loads_every_leaf_exactly(ref_model):
    _, _, params, tree = ref_model
    model = params_from_arrays(get_arch(ARCH, reduced=True), tree, "cpu")
    np.testing.assert_array_equal(model.embed.weight.numpy(), tree["embed"])
    np.testing.assert_array_equal(model.final_norm.numpy(), tree["final_norm"])
    np.testing.assert_array_equal(model.lm_head.weight.numpy().T, tree["lm_head"])
    m, s = tree["stages"][0]["mlstm"], tree["stages"][0]["slstm"]
    assert len(model.blocks) == 2
    for i, block in enumerate(model.blocks):
        np.testing.assert_array_equal(block.mlstm_ln.numpy(), m["ln"][i])
        np.testing.assert_array_equal(block.slstm_ln.numpy(), s["ln"][i])
        for n in ("up_proj", "wq", "wk", "wv", "w_if", "down_proj"):
            np.testing.assert_array_equal(getattr(block.mlstm, n).weight.numpy().T,
                                          m["mixer"][n][i])
        for n in ("b_if", "norm_g"):
            np.testing.assert_array_equal(getattr(block.mlstm, n).numpy(), m["mixer"][n][i])
        for n in ("w_in", "out_proj"):
            np.testing.assert_array_equal(getattr(block.slstm, n).weight.numpy().T,
                                          s["mixer"][n][i])
        for n in ("r", "b", "norm_g"):
            np.testing.assert_array_equal(getattr(block.slstm, n).numpy(), s["mixer"][n][i])
    assert model.n_params() == sum(a.size for a in jax.tree_util.tree_leaves(tree))
    short = dict(tree, stages=(jax.tree_util.tree_map(lambda a: a[:1], tree["stages"][0]),))
    with pytest.raises(ValueError, match="1 layers"):
        params_from_arrays(get_arch(ARCH, reduced=True), short, "cpu")


@pytest.mark.parametrize("s", [32, 24])
def test_forward_matches(ref_model, s):
    cfg, jmodel, params, tree = ref_model
    tokens = _tokens(2, s, cfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(params, {"tokens": jnp.asarray(tokens)})
    model = params_from_arrays(get_arch(ARCH, reduced=True), tree, "cpu")
    got, aux = model(torch.from_numpy(tokens))
    assert got.shape == (2, s, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _ref_run(ref_model, s):
    """The reference's prefill of a [2, s] prompt and N_DECODE greedy decode
    steps: (tokens, prefill logits, prefill cache, [(logits, token)], final
    cache), as numpy."""
    cfg, jmodel, params, _ = ref_model
    tokens = _tokens(2, s, cfg.vocab_size, seed=s)
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=s + 8))
    decode = jax.jit(jmodel.decode_step)
    logits, cache = prefill(params, jnp.asarray(tokens))
    pre = (np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache))
    steps = []
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for i in range(N_DECODE):
        logits, cache = decode(params, tok, cache, jnp.asarray(s + i, jnp.int32))
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]
        steps.append((np.asarray(logits), np.asarray(tok)))
    return tokens, pre, steps, jax.tree_util.tree_map(np.asarray, cache)


def _assert_cache_matches(cache: XLstmCache, ref_cache):
    """The port's stacked cache against the reference's stage cache
    ``{"mlstm": (h, n), "slstm": SLstmState(c, n, m, h)}``."""
    (stage,) = ref_cache
    want = list(stage["mlstm"]) + list(stage["slstm"])
    assert len(cache) == len(want) == 6
    for got, ref in zip(cache, want):
        assert got.shape == ref.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("impl", S.GLA_IMPLS)
@pytest.mark.parametrize("s", [32, 24])
def test_prefill_and_decode_match(ref_model, s, impl):
    _, _, _, tree = ref_model
    tokens, (pre_logits, pre_cache), steps, final_cache = _ref_run(ref_model, s)
    model = params_from_arrays(get_arch(ARCH, reduced=True), tree, "cpu", gla_impl=impl)
    ssd.reset_launches()
    logits, cache = model.prefill(torch.from_numpy(tokens), cache_len=s + 8)
    assert ssd.LAUNCHES["ssd_scan"] == 0  # the CPU route launches nothing
    assert isinstance(cache, XLstmCache)
    np.testing.assert_allclose(logits.numpy(), pre_logits, atol=1e-4, rtol=1e-4)
    _assert_cache_matches(cache, pre_cache)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i, (want_logits, want_tok) in enumerate(steps):
        logits, cache = model.decode_step(tok, cache, s + i)
        np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-4, rtol=1e-4)
        tok = logits[:, 0].argmax(-1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), want_tok)
    _assert_cache_matches(cache, final_cache)


def test_bf16_prefill_and_decode_match():
    jcfg = jget_arch(ARCH, reduced=True).replace(dtype_name="bfloat16")
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(7))
    model = params_from_arrays(get_arch(ARCH, reduced=True).replace(dtype_name="bfloat16"),
                               _tree_np(params), "cpu")
    assert model.blocks[0].mlstm.wq.weight.dtype == torch.bfloat16
    assert model.blocks[0].mlstm.w_if.weight.dtype == torch.float32
    tokens = _tokens(2, 16, jcfg.vocab_size, seed=8)
    want, jcache = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=24))(
        params, jnp.asarray(tokens))
    got, cache = model.prefill(torch.from_numpy(tokens), cache_len=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.1, rtol=0.05)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    decode = jax.jit(jmodel.decode_step)
    for i in range(3):
        want, jcache = decode(params, jnp.asarray(tok), jcache, jnp.asarray(16 + i, jnp.int32))
        got, cache = model.decode_step(torch.from_numpy(tok).long(), cache, 16 + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.1, rtol=0.05)
        tok = np.asarray(jnp.argmax(want[:, 0], -1))[:, None].astype(np.int32)


def test_init_draws_the_reference_distributions():
    """Port init: the reference's distributions and constants (not its
    numbers), the same parameter count, a zero state with the sLSTM's m at
    -10."""
    cfg = get_arch(ARCH, reduced=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    again = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    block = model.blocks[1]
    assert torch.equal(block.mlstm.b_if, torch.tensor([0.0] * 4 + [3.0] * 4))
    assert torch.equal(block.slstm.b, torch.cat([torch.zeros(192), 3.0 * torch.ones(64)]))
    assert abs(float(block.mlstm.wq.weight.std()) - (1 / 128) ** 0.5) < 0.01
    assert abs(float(block.slstm.r.std()) - (1 / 16) ** 0.5) < 0.02
    jmodel = jbuild(jget_arch(ARCH, reduced=True))
    assert model.n_params() == jmodel.n_params(jmodel.init(jax.random.PRNGKey(0)))
    cache = model.init_cache(3, 99)
    assert cache.mlstm_h.shape == (2, 3, 4, 32, 32) and cache.mlstm_n.shape == (2, 3, 4, 32, 1)
    assert cache.slstm_c.shape == (2, 3, 64) and not cache.slstm_c.any()
    assert torch.equal(cache.slstm_m, torch.full((2, 3, 64), -10.0))


def test_greedy_tokens_equal_the_reference(ref_model):
    """Eight greedy tokens after a 32-token prompt, generated by each side."""
    cfg, jmodel, params, tree = ref_model
    tokens = _tokens(1, 32, cfg.vocab_size, seed=5)
    logits, cache = jmodel.prefill(params, {"tokens": jnp.asarray(tokens)}, cache_len=48)
    want = [int(jnp.argmax(logits[0, -1]))]
    for i in range(7):
        logits, cache = jmodel.decode_step(params, jnp.asarray([[want[-1]]], jnp.int32), cache,
                                           jnp.asarray(32 + i, jnp.int32))
        want.append(int(jnp.argmax(logits[0, 0])))
    model = params_from_arrays(get_arch(ARCH, reduced=True), tree, "cpu")
    logits, pcache = model.prefill(torch.from_numpy(tokens), cache_len=48)
    got = [int(logits[0, -1].argmax())]
    for i in range(7):
        logits, pcache = model.decode_step(torch.tensor([[got[-1]]]), pcache, 32 + i)
        got.append(int(logits[0, 0].argmax()))
    assert got == want


def test_config_copies_the_reference():
    for reduced in (False, True):
        cfg, jcfg = get_arch(ARCH, reduced=reduced), jget_arch(ARCH, reduced=reduced)
        for field in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab_size", "ssm_expand", "sub_quadratic", "norm_eps", "gla_chunk",
                      "dtype_name", "source", "hd", "padded_vocab", "block_program"):
            a, b = getattr(cfg, field), getattr(jcfg, field)
            assert (a() if callable(a) else a) == (b() if callable(b) else b), field
    cfg = get_arch(ARCH)
    assert cfg.block_program() == (("xlstm_pair", 12),) and cfg.dtype == torch.bfloat16
    assert (cfg.d_model, cfg.n_heads, cfg.padded_vocab, cfg.gla_chunk) == (1024, 4, 50432, 128)
    assert get_arch(ARCH, reduced=True).dtype == torch.float32


def test_standalone_recurrent_stages_raise_naming_their_roadmap_item():
    cfg = get_arch(ARCH, reduced=True)
    for stages in ((("mlstm", 2),), (("slstm", 2),), (("xlstm_pair", 1), ("dense", 1))):
        with pytest.raises(NotImplementedError, match="item 12c"):
            build_model(cfg.replace(stages=stages), "cpu")
    with pytest.raises(ValueError, match="gla_impl"):
        build_model(cfg, "cpu", gla_impl="pallas")
