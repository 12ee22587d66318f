"""The PyTorch port's dense archs beyond internlm2 — ``glm4-9b`` (GQA 16:1
at full width), ``stablelm-3b`` (head dim 80 at full width) and
``qwen3-14b`` (qk-norm) — against the JAX reference at their reduced
configurations (3 layers, d 64, f32), on the same parameters.

The reference's parameters come across with ``convert.params_from_arrays``;
inputs come from numpy with a fixed seed. The attention layer agrees to f32
rounding (1e-5); forward, prefill and decode logits to 1e-4 (the two
frameworks differ only in summation order), with identical greedy tokens,
as ``tests/test_torch_lm.py`` holds internlm2. Decode runs 8 steps at an
int position and at a ``[B]`` tensor of positions; the reference's
``decode_step`` takes one position, so each row of the ``[B]`` step is held
against its own sequence decoded alone.
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
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_arrays

ARCHS = ("glm4-9b", "stablelm-3b", "qwen3-14b")
# the kernel that serves each full config's prefill on the card
VARIANT = {"glm4-9b": "wgmma", "stablelm-3b": "wgmma", "qwen3-14b": "wgmma"}
N_DECODE = 8
PROMPT, CACHE = 24, 40
TOL = dict(atol=1e-4, rtol=1e-4)


def _tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _tokens(b, s, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


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


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch, reduced):
    cfg, jcfg = get_arch(arch, reduced=reduced), jget_arch(arch, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.hd, cfg.padded_vocab, cfg.block_program()) == (
        jcfg.hd, jcfg.padded_vocab, jcfg.block_program())
    assert cfg.dtype == (torch.float32 if reduced else torch.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_variant_of_the_full_config(arch):
    cfg = get_arch(arch)
    assert fa.variant(cfg.dtype, cfg.hd) == VARIANT[arch]
    assert (cfg.n_heads // cfg.n_kv_heads, cfg.hd) == {
        "glm4-9b": (16, 128), "stablelm-3b": (1, 80), "qwen3-14b": (5, 128)}[arch]


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("arch", ARCHS)
def test_attn_qkv_matches(arch):
    """Projections, qk-norm (with gains away from 1) and RoPE."""
    cfg = get_arch(arch, reduced=True)
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = JL.attn_init(jax.random.PRNGKey(1), d, h, kh, hd, cfg.qk_norm, jnp.float32)
    rng = np.random.default_rng(7)
    if cfg.qk_norm:
        p = dict(p, q_norm=jnp.asarray(rng.normal(size=hd), jnp.float32),
                 k_norm=jnp.asarray(rng.normal(size=hd), jnp.float32))
    attn = L.Attention(d, h, kh, hd, torch.float32, theta=cfg.rope_theta,
                       qk_norm=cfg.qk_norm, eps=cfg.norm_eps)
    assert (attn.q_norm is not None) == cfg.qk_norm
    with torch.no_grad():
        for n in ("wq", "wk", "wv", "wo"):
            getattr(attn, n).weight.copy_(_t(p[n]).t())
        if cfg.qk_norm:
            attn.q_norm.copy_(_t(p["q_norm"]))
            attn.k_norm.copy_(_t(p["k_norm"]))
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    pos = np.arange(9) + 5
    want = JL.attn_qkv(p, jnp.asarray(x), h, kh, hd, jnp.asarray(pos), cfg.rope_theta,
                       cfg.qk_norm, cfg.norm_eps)
    with torch.no_grad():
        got = attn.qkv(_t(x), torch.from_numpy(pos))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_qk_norm_init_and_params_from_arrays_load_the_gains():
    cfg = get_arch("qwen3-14b", reduced=True)
    jmodel = jbuild(jget_arch("qwen3-14b", reduced=True))
    tree = _tree_np(jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    attn = tree["stages"][0]["attn"]
    attn["q_norm"] = rng.normal(size=attn["q_norm"].shape).astype(np.float32)
    attn["k_norm"] = rng.normal(size=attn["k_norm"].shape).astype(np.float32)
    model = params_from_arrays(cfg, tree, "cpu")
    for i, block in enumerate(model.blocks):
        np.testing.assert_array_equal(block.attn.q_norm.numpy(), attn["q_norm"][i])
        np.testing.assert_array_equal(block.attn.k_norm.numpy(), attn["k_norm"][i])
    model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(b.attn.q_norm, torch.ones(cfg.hd)) for b in model.blocks)


# ---------------------------------------------------------------- model

def test_n_params_and_every_leaf(ref):
    arch, jmodel, params, tree, model = ref
    assert model.n_params() == jmodel.n_params(params)
    stage = tree["stages"][0]
    for i, block in enumerate(model.blocks):
        for n in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(getattr(block.attn, n).weight.numpy().T,
                                          stage["attn"][n][i])
        if arch == "qwen3-14b":
            for n in ("q_norm", "k_norm"):
                np.testing.assert_array_equal(getattr(block.attn, n).numpy(),
                                              stage["attn"][n][i])
        else:
            assert block.attn.q_norm is None and "q_norm" not in stage["attn"]


def test_forward_matches(ref):
    arch, jmodel, params, _, model = ref
    cfg = get_arch(arch, reduced=True)
    tokens = _tokens(2, 32, cfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(params, {"tokens": jnp.asarray(tokens)})
    got, aux = model(torch.from_numpy(tokens))
    assert got.shape == (2, 32, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    tok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None].astype(np.int32)
    for i in range(N_DECODE):
        want, jcache = decode(params, jnp.asarray(tok), jcache, jnp.asarray(PROMPT + i, jnp.int32))
        got, cache = model.decode_step(torch.from_numpy(tok).long(), cache, PROMPT + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(jnp.argmax(want[:, 0], -1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(got[:, 0].argmax(-1).numpy(), tok[:, 0])
    (jk, _), = jcache
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)


def test_row_position_decode_matches_each_row_alone(ref):
    """Two prompts of 13 and 24 tokens, each prefilled alone into a 40-slot
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


def test_serve_takes_a_config_in_place_of_the_arch():
    """``serve.main(config=...)`` serves that config (here glm4-9b's reduced
    one cut to 1 layer) whatever ``--arch`` names: each request's tokens
    are the cut model's own greedy prefill + decode."""
    cfg = get_arch("glm4-9b", reduced=True).replace(n_layers=1)
    stats = {}
    result = serve.main(["--requests", "2", "--slots", "2", "--prompt-len", "8", "--max-new",
                         "3", "--cache-len", "16", "--device", "cpu"], stats=stats,
                        config=cfg)
    assert (result["arch"], result["total_tokens"]) == ("glm4-9b", 6)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert len(model.blocks) == 1
    rng = np.random.default_rng(0)
    for rid in range(2):
        prompt = rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
        logits, cache = model.prefill(torch.from_numpy(prompt[None]), cache_len=16)
        toks = [int(logits[0, -1].argmax())]
        for i in range(2):
            logits, cache = model.decode_step(torch.tensor([[toks[-1]]]), cache, 8 + i)
            toks.append(int(logits[0, -1].argmax()))
        assert stats["tokens"][rid] == toks


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("h,kh,hd", [(32, 32, 80), (32, 2, 128), (40, 8, 128)])
def test_cuda_flash_at_the_full_configs_matches_plain(h, kh, hd, dtype, tol):
    """The serve prefills' shapes (stablelm-3b and zamba2's shared attention
    at hd 80, glm4-9b, qwen3-14b) on the variant the table names."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 1024, n, hd), generator=gen, device="cuda").to(dtype)
               for n in (h, kh, kh))
    route = fa.variant(dtype, hd)
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[f"flash_attention_{route}"] == 1
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
