"""The PyTorch port's two front ends against the JAX reference at their
reduced configurations (f32), on the same parameters: ``internvl2-26b``
(image embeds in place of the first ``n_image_embeds`` token embeddings)
and ``whisper-tiny`` (an encoder over frame embeddings plus sinusoidal
positions, and ``dec`` blocks with cached self attention, cross attention
over the encoder's memory and a GELU MLP).

Each arch: forward, prefill with its extras and its caches field by field,
8 int-position decode steps, ``[B]`` position decode row by row (each row
prefilled alone with its own extras), the parameters and their count; the
pieces (sinusoidal positions, the GELU MLP with ``jax.nn.gelu``'s tanh
form, cross attention) against theirs; serve's cache insert writes every
layer of both halves of the encoder-decoder cache; whisper's serve loop
with ``--per-slot-positions`` against each request's own greedy run.
Tolerances are ``tests/test_torch_dense_archs.py``'s: 1e-4 on logits, 1e-5
on layers and caches. Inputs come from numpy with a fixed seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro.models.transformer import _sinusoidal
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import EncDecCache, build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_arrays

ARCHS = ("internvl2-26b", "whisper-tiny")
N_DECODE = 8
PROMPT, CACHE = 24, 40
TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _tokens(b, s, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _extras(cfg, b, seed=4):
    """(the reference's batch extras, the port's keyword arguments): random
    image embeds or encoder frames."""
    rng = np.random.default_rng(seed)
    if cfg.n_image_embeds:
        a = rng.normal(size=(b, cfg.n_image_embeds, cfg.d_model)).astype(np.float32)
        return {"image_embeds": jnp.asarray(a)}, {"image_embeds": _t(a)}
    a = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {"encoder_frames": jnp.asarray(a)}, {"encoder_frames": _t(a)}


def _cache_close(cache, jcache):
    """The port's cache against the reference's stage cache, field by field."""
    (jc,), = (jcache,)
    if isinstance(cache, EncDecCache):
        want = (*jc["self"], *jc["cross"])
    else:
        want = jc
    assert len(cache) == len(want)
    for got, w in zip(cache, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **LAYER_TOL)


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


# ---------------------------------------------------------------- configs and pieces

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch, reduced):
    cfg, jcfg = get_arch(arch, reduced=reduced), jget_arch(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.block_program() == jcfg.block_program()


def test_flash_variants_of_the_full_configs():
    vl, wh = get_arch("internvl2-26b"), get_arch("whisper-tiny")
    assert (vl.n_heads, vl.n_kv_heads, vl.hd, fa.variant(vl.dtype, vl.hd)) == (48, 8, 128,
                                                                               "wgmma")
    assert (wh.n_heads, wh.hd, wh.encoder_seq, fa.variant(wh.dtype, wh.hd)) == (6, 64, 1500,
                                                                                "wgmma")


@pytest.mark.parametrize("d", [64, 384])
def test_sinusoidal_matches(d):
    # at whisper's 1500 frames the angles reach 1500 rad, where one f32 ulp
    # of the angle is 1.2e-4: the two frameworks' sines differ by that
    pos = np.arange(1500)
    np.testing.assert_allclose(L.sinusoidal(torch.from_numpy(pos), d).numpy(),
                               np.asarray(_sinusoidal(jnp.asarray(pos), d)), atol=2e-4, rtol=0)
    short = np.arange(30)
    np.testing.assert_allclose(L.sinusoidal(torch.from_numpy(short), d).numpy(),
                               np.asarray(_sinusoidal(jnp.asarray(short), d)), **LAYER_TOL)


def test_gelu_mlp_matches_with_biases():
    p = JL.gelu_mlp_init(jax.random.PRNGKey(2), 32, 48, jnp.float32)
    rng = np.random.default_rng(9)
    p = dict(p, b_in=jnp.asarray(rng.normal(size=48), jnp.float32),
             b_out=jnp.asarray(rng.normal(size=32), jnp.float32))
    mlp = L.GeluMLP(32, 48, torch.float32)
    with torch.no_grad():
        for n in ("w_in", "w_out"):
            getattr(mlp, n).weight.copy_(_t(p[n]).t())
        mlp.w_in.bias.copy_(_t(p["b_in"]))
        mlp.w_out.bias.copy_(_t(p["b_out"]))
        x = rng.normal(size=(2, 7, 32)).astype(np.float32) * 3
        got = mlp(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(JL.gelu_mlp_apply(p, jnp.asarray(x))),
                               **LAYER_TOL)


def test_cross_attention_matches_and_fills_its_cache():
    """Fresh memory (the kernel route's plain version on the CPU) and the
    cached memory (decode's plain route) against the reference's
    ``attention_naive`` over projected memory."""
    d, h, hd, sm = 32, 2, 16, 30
    p = JL.attn_init(jax.random.PRNGKey(3), d, h, h, hd, False, jnp.float32)
    attn = L.Attention(d, h, h, hd, torch.float32, theta=0.0)
    with torch.no_grad():
        for n in ("wq", "wk", "wv", "wo"):
            getattr(attn, n).weight.copy_(_t(p[n]).t())
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    mem = rng.normal(size=(2, sm, d)).astype(np.float32)
    q = (jnp.asarray(x) @ p["wq"]).reshape(2, 5, h, hd)
    km = (jnp.asarray(mem) @ p["wk"]).reshape(2, sm, h, hd)
    vm = (jnp.asarray(mem) @ p["wv"]).reshape(2, sm, h, hd)
    want = JL.attention_naive(q, km, vm, causal=False).reshape(2, 5, h * hd) @ p["wo"]
    cache = (torch.zeros((2, sm, h, hd)), torch.zeros((2, sm, h, hd)))
    with torch.no_grad():
        fresh = attn.cross(_t(x), _t(mem), cache)
        cached = attn.cross(_t(x), None, cache)
    np.testing.assert_allclose(cache[0].numpy(), np.asarray(km), **LAYER_TOL)
    np.testing.assert_allclose(cache[1].numpy(), np.asarray(vm), **LAYER_TOL)
    np.testing.assert_allclose(fresh.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(cached.numpy(), np.asarray(want), **LAYER_TOL)


def test_front_end_inputs_are_required_and_the_length_is_kept():
    vl = build_model(get_arch("internvl2-26b", reduced=True), "cpu").init(
        torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 12), dtype=torch.int64)
    with pytest.raises(ValueError, match="image_embeds"):
        vl.prefill(tokens)
    extras = serve.front_end_inputs(vl.config, 1, "cpu")
    assert extras["image_embeds"].shape == (1, vl.config.n_image_embeds, vl.config.d_model)
    assert vl(tokens, **extras)[0].shape == (1, 12, vl.config.padded_vocab)
    wh = build_model(get_arch("whisper-tiny", reduced=True), "cpu").init(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder_frames"):
        wh(tokens)
    extras = serve.front_end_inputs(wh.config, 1, "cpu")
    assert extras["encoder_frames"].shape == (1, wh.config.encoder_seq, wh.config.d_model)
    assert set(serve.front_end_inputs(get_arch("glm4-9b", reduced=True), 1, "cpu")) == set()


# ---------------------------------------------------------------- the archs

def test_n_params_and_the_front_end_leaves(ref):
    arch, jmodel, params, tree, model = ref
    assert model.n_params() == jmodel.n_params(params)
    if arch != "whisper-tiny":
        assert model.encoder is None
        return
    enc = tree["encoder"]
    np.testing.assert_array_equal(model.encoder.final_norm.numpy(), enc["final_norm"])
    for i, block in enumerate(model.encoder.blocks):
        np.testing.assert_array_equal(block.attn.wq.weight.numpy().T, enc["stage"]["attn"]["wq"][i])
        np.testing.assert_array_equal(block.mlp.w_in.bias.numpy(), enc["stage"]["mlp"]["b_in"][i])
    dec = tree["stages"][0]
    for i, block in enumerate(model.blocks):
        np.testing.assert_array_equal(block.cross_attn.wk.weight.numpy().T,
                                      dec["cross_attn"]["wk"][i])
        np.testing.assert_array_equal(block.ln3.numpy(), dec["ln3"][i])
        np.testing.assert_array_equal(block.mlp.w_out.weight.numpy().T, dec["mlp"]["w_out"][i])


def test_params_from_arrays_refuses_an_encoder_of_another_depth():
    jmodel = jbuild(jget_arch("whisper-tiny", reduced=True))
    tree = _tree_np(jmodel.init(jax.random.PRNGKey(0)))
    enc = tree["encoder"]
    short = dict(tree, encoder=dict(enc, stage=jax.tree_util.tree_map(lambda a: a[:1],
                                                                      enc["stage"])))
    with pytest.raises(ValueError, match="encoder.stage holds 1 layers"):
        params_from_arrays(get_arch("whisper-tiny", reduced=True), short, "cpu")


def test_forward_matches(ref):
    arch, jmodel, params, _, model = ref
    cfg = get_arch(arch, reduced=True)
    tokens = _tokens(2, 32, cfg.vocab_size)
    jx, tx = _extras(cfg, 2)
    want, want_aux = jax.jit(jmodel.forward)(params, {"tokens": jnp.asarray(tokens), **jx})
    got, aux = model(torch.from_numpy(tokens), **tx)
    assert got.shape == (2, 32, cfg.padded_vocab)
    assert float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_int_position_decode_match(ref):
    arch, jmodel, params, _, model = ref
    cfg = get_arch(arch, reduced=True)
    tokens = _tokens(2, PROMPT, cfg.vocab_size)
    jx, tx = _extras(cfg, 2)
    prefill = jax.jit(lambda p, batch: jmodel.prefill(p, batch, cache_len=CACHE))
    decode = jax.jit(jmodel.decode_step)
    want, jcache = prefill(params, {"tokens": jnp.asarray(tokens), **jx})
    got, cache = model.prefill(torch.from_numpy(tokens), cache_len=CACHE, **tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _cache_close(cache, jcache)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    for i in range(N_DECODE):
        want, jcache = decode(params, jnp.asarray(tok), jcache, jnp.asarray(PROMPT + i, jnp.int32))
        got, cache = model.decode_step(torch.from_numpy(tok).long(), cache, PROMPT + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(jnp.argmax(want[:, 0], -1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(got[:, 0].argmax(-1).numpy(), tok[:, 0])
    _cache_close(cache, jcache)


def test_row_position_decode_matches_each_row_alone(ref):
    """Prompts of 13 and 24 tokens, each prefilled alone with its own
    extras into a 40-slot cache and inserted into a batch of 2; 8 steps at
    ``[B]`` positions, each row against its own sequence on the JAX model
    API."""
    arch, jmodel, params, _, model = ref
    cfg = get_arch(arch, reduced=True)
    prefill = jax.jit(lambda p, batch: jmodel.prefill(p, batch, cache_len=CACHE))
    decode = jax.jit(jmodel.decode_step)
    lengths = (13, PROMPT)
    cache = model.init_cache(len(lengths), CACHE)
    jcaches, toks = [], []
    for b, n in enumerate(lengths):
        prompt = _tokens(1, n, cfg.vocab_size, seed=10 + b)
        jx, tx = _extras(cfg, 1, seed=20 + b)
        want, jc = prefill(params, {"tokens": jnp.asarray(prompt), **jx})
        got, small = model.prefill(torch.from_numpy(prompt), cache_len=CACHE, **tx)
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


# ---------------------------------------------------------------- serve

def test_insert_cache_writes_every_layer_of_both_halves():
    model = build_model(get_arch("whisper-tiny", reduced=True), "cpu")
    big = model.init_cache(3, 8)
    assert isinstance(big, EncDecCache)
    assert big.cross_k.shape[2] == model.config.encoder_seq
    small = EncDecCache(*(torch.rand((f.shape[0], 1) + f.shape[2:]) for f in big))
    before = [f.clone() for f in big]
    serve.insert_cache(big, small, 1)
    for got, src, old in zip(big, small, before):
        assert torch.equal(got[:, 1], src[:, 0])
        assert torch.equal(got[:, 0], old[:, 0]) and torch.equal(got[:, 2], old[:, 2])


def test_whisper_serve_per_slot_positions_gives_every_request_its_own_tokens():
    """The reduced whisper served with ``--per-slot-positions`` and the
    reference loop's zero frames, 6 requests on 2 slots: each request's
    tokens are its own greedy prefill + decode, alone."""
    arch, n_req, prompt_len, max_new, cache_len = "whisper-tiny", 6, 16, 6, 48
    stats = {}
    result = serve.main(["--arch", arch, "--reduced", "--requests", str(n_req), "--slots", "2",
                         "--prompt-len", str(prompt_len), "--max-new", str(max_new),
                         "--cache-len", str(cache_len), "--device", "cpu",
                         "--per-slot-positions"], stats=stats)
    assert (result["arch"], result["total_tokens"]) == (arch, n_req * max_new)
    model = build_model(get_arch(arch, reduced=True), "cpu").init(
        torch.Generator().manual_seed(0))
    extras = serve.front_end_inputs(model.config, 1, "cpu")
    assert not extras["encoder_frames"].any()
    rng = np.random.default_rng(0)
    for rid in range(n_req):
        prompt = rng.integers(0, model.config.vocab_size, size=prompt_len).astype(np.int32)
        logits, cache = model.prefill(torch.from_numpy(prompt[None]), cache_len=cache_len,
                                      **extras)
        toks = [int(logits[0, -1].argmax())]
        for i in range(max_new - 1):
            logits, cache = model.decode_step(torch.tensor([[toks[-1]]]), cache, prompt_len + i)
            toks.append(int(logits[0, -1].argmax()))
        assert stats["tokens"][rid] == toks, rid
