"""The PyTorch port's dense LM (``internlm2-1.8b`` reduced: 3 layers, d 64,
f32) against the JAX reference on the same parameters.

The reference's parameters come across with ``convert.params_from_arrays``;
inputs come from numpy with a fixed seed. Layers agree to f32 rounding
(atol 1e-5 or tighter); prefill and decode logits to atol 1e-4 (the
reference's bar for the cached paths against each other is 2e-2; the two
frameworks differ only in summation order), with identical greedy tokens.
The bf16 variant is held at atol 0.1 on logits of magnitude ~1-5: bf16
keeps 8 bits of mantissa, and the two frameworks round at different points
(silu, the logits einsum), so the difference is a few bf16 ulps of the
logits.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internlm2-1.8b"
N_DECODE = 8


def _tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


@pytest.fixture(scope="module")
def ref_model():
    """(cfg, JAX model, JAX params, the params as f32 numpy)."""
    cfg = jget_arch(ARCH, reduced=True)
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, _tree_np(params)


def _tokens(b, s, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_rms_norm_matches(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    g = rng.normal(size=(64,)).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(g, dtype), 1e-5)
    got = L.rms_norm(_t(x, getattr(torch, dtype)), _t(g, getattr(torch, dtype)), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_apply_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7) + 3
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = L.apply_rope(_t(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_attention_naive_matches():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    want = JL.attention_naive(*map(jnp.asarray, (q, k, v)), True, 3)
    got = L.attention_naive(*map(_t, (q, k, v)), True, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _port_attention(p, d, h, kh, hd):
    attn = L.Attention(d, h, kh, hd, torch.float32, theta=10000.0)
    with torch.no_grad():
        for n in ("wq", "wk", "wv", "wo"):
            getattr(attn, n).weight.copy_(_t(p[n]).t())
    return attn


@pytest.mark.parametrize("impl", ["auto", "naive"])
def test_attn_apply_with_cache_matches(impl):
    """Prefill at cache_pos 0, then two one-token decodes: outputs and the
    cache written in place match the reference's returned cache."""
    d, h, kh, hd, s_max = 64, 4, 2, 16, 12
    p = JL.attn_init(jax.random.PRNGKey(1), d, h, kh, hd, False, jnp.float32)
    attn = _port_attention(p, d, h, kh, hd)
    rng = np.random.default_rng(4)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd, theta=10000.0)
    jc = (jnp.zeros((2, s_max, kh, hd)), jnp.zeros((2, s_max, kh, hd)))
    tc = (torch.zeros((2, s_max, kh, hd)), torch.zeros((2, s_max, kh, hd)))
    for pos, s in ((0, 6), (6, 1), (7, 1)):
        x = rng.normal(size=(2, s, d)).astype(np.float32)
        positions = np.arange(pos, pos + s)
        want, jc = JL.attn_apply(p, jnp.asarray(x), positions=jnp.asarray(positions),
                                 cache=jc, cache_pos=jnp.asarray(pos), **kw)
        with torch.no_grad():
            got = attn(_t(x), torch.from_numpy(positions), cache=tc, cache_pos=pos,
                       attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


def test_attn_without_cache_matches_reference():
    d, h, kh, hd = 64, 4, 2, 16
    p = JL.attn_init(jax.random.PRNGKey(2), d, h, kh, hd, False, jnp.float32)
    attn = _port_attention(p, d, h, kh, hd)
    x = np.random.default_rng(5).normal(size=(2, 10, d)).astype(np.float32)
    want, _ = JL.attn_apply(p, jnp.asarray(x), n_heads=h, n_kv_heads=kh, head_dim=hd,
                            positions=jnp.arange(10), theta=10000.0)
    with torch.no_grad():
        got = attn(_t(x), torch.arange(10))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_swiglu_matches():
    p = JL.swiglu_init(jax.random.PRNGKey(3), 64, 192, jnp.float32)
    mlp = L.SwiGLU(64, 192, torch.float32)
    with torch.no_grad():
        for n in ("w_gate", "w_up", "w_down"):
            getattr(mlp, n).weight.copy_(_t(p[n]).t())
    x = np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32)
    want = JL.swiglu_apply(p, jnp.asarray(x))
    with torch.no_grad():
        got = mlp(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_init_draws_the_reference_distributions():
    """Port init: weights from the reference's distributions (not its
    numbers), norms at 1, same parameter count."""
    cfg = get_arch(ARCH, reduced=True)
    gen = torch.Generator().manual_seed(0)
    model = build_model(cfg, "cpu").init(gen)
    again = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    wq = model.blocks[0].attn.wq.weight
    assert abs(float(wq.std()) - (1 / 64) ** 0.5) < 0.01
    assert abs(float(model.embed.weight.std()) - 0.02) < 0.002
    assert torch.equal(model.blocks[1].ln2, torch.ones(64))
    jcfg = jget_arch(ARCH, reduced=True)
    jmodel = jbuild(jcfg)
    assert model.n_params() == jmodel.n_params(jmodel.init(jax.random.PRNGKey(0)))


# ---------------------------------------------------------------- model

def test_params_from_arrays_loads_every_leaf_exactly(ref_model):
    cfg, _, _, tree = ref_model
    model = params_from_arrays(get_arch(ARCH, reduced=True), tree, "cpu")
    np.testing.assert_array_equal(model.embed.weight.numpy(), tree["embed"])
    np.testing.assert_array_equal(model.final_norm.numpy(), tree["final_norm"])
    np.testing.assert_array_equal(model.lm_head.weight.numpy().T, tree["lm_head"])
    stage = tree["stages"][0]
    for i, block in enumerate(model.blocks):
        np.testing.assert_array_equal(block.ln1.numpy(), stage["ln1"][i])
        np.testing.assert_array_equal(block.ln2.numpy(), stage["ln2"][i])
        for n in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                getattr(block.attn, n).weight.numpy().T, stage["attn"][n][i])
        for n in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                getattr(block.mlp, n).weight.numpy().T, stage["mlp"][n][i])
    assert model.n_params() == sum(a.size for a in jax.tree_util.tree_leaves(tree))
    short = dict(tree, stages=(jax.tree_util.tree_map(lambda a: a[:2], stage),))
    with pytest.raises(ValueError, match="2 layers"):
        params_from_arrays(get_arch(ARCH, reduced=True), short, "cpu")


def test_forward_matches(ref_model):
    cfg, jmodel, params, tree = ref_model
    tokens = _tokens(2, 24, cfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(params, {"tokens": jnp.asarray(tokens)})
    model = params_from_arrays(get_arch(ARCH, reduced=True), tree, "cpu")
    got, aux = model(torch.from_numpy(tokens))
    assert got.shape == (2, 24, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ref_run(ref_model):
    """The reference's prefill of a [2, 24] prompt into a 40-slot cache and
    N_DECODE greedy decode steps: (tokens, prefill logits, caches, [(logits,
    next token)] per step)."""
    cfg, jmodel, params, _ = ref_model
    tokens = _tokens(2, 24, cfg.vocab_size)
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=40))
    decode = jax.jit(jmodel.decode_step)
    logits, cache = prefill(params, jnp.asarray(tokens))
    pre = (np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache))
    steps = []
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    for i in range(N_DECODE):
        logits, cache = decode(params, tok, cache, jnp.asarray(24 + i, jnp.int32))
        tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]
        steps.append((np.asarray(logits), np.asarray(tok)))
    return tokens, pre, jax.tree_util.tree_map(np.asarray, cache), steps


@pytest.mark.parametrize("impl", ["auto", "naive"])
def test_prefill_and_decode_match(ref_model, ref_run, impl):
    _, _, _, tree = ref_model
    tokens, (pre_logits, pre_cache), final_cache, steps = ref_run
    model = params_from_arrays(get_arch(ARCH, reduced=True), tree, "cpu", attn_impl=impl)
    fa.reset_launches()
    logits, cache = model.prefill(torch.from_numpy(tokens), cache_len=40)
    assert fa.LAUNCHES["flash_attention"] == 0  # the CPU route launches nothing
    assert logits.shape == pre_logits.shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), pre_logits, atol=1e-4, rtol=1e-4)
    (jk, jv), = pre_cache
    np.testing.assert_allclose(cache.k.numpy(), jk, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cache.v.numpy(), jv, atol=1e-5, rtol=1e-5)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i, (want_logits, want_tok) in enumerate(steps):
        logits, cache = model.decode_step(tok, cache, 24 + i)
        np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-4, rtol=1e-4)
        tok = logits[:, 0].argmax(-1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), want_tok)
    (jk, jv), = final_cache
    np.testing.assert_allclose(cache.k.numpy(), jk, atol=1e-5, rtol=1e-5)


def test_bf16_prefill_and_decode_match():
    jcfg = jget_arch(ARCH, reduced=True).replace(dtype_name="bfloat16")
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(7))
    model = params_from_arrays(get_arch(ARCH, reduced=True).replace(dtype_name="bfloat16"),
                               _tree_np(params), "cpu")
    assert model.embed.weight.dtype == torch.bfloat16
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


# ---------------------------------------------------------------- configs

def test_configs_copy_the_reference():
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size",
                  "rope_theta", "norm_eps", "hd", "padded_vocab", "block_program"):
        a, b = getattr(cfg, field), getattr(jcfg, field)
        assert (a() if callable(a) else a) == (b() if callable(b) else b), field
    assert cfg.dtype == torch.bfloat16 and get_arch(ARCH, reduced=True).dtype == torch.float32
    assert (cfg.n_layers, cfg.d_model, cfg.hd, cfg.padded_vocab) == (24, 2048, 128, 92672)
    assert list_archs() == jlist_archs()


def test_unknown_arch_and_block_types_raise():
    """Every registered arch builds, and so do mixed programs and standalone
    stages (``test_torch_mixed_programs.py``, which also holds an unknown
    block type's ``ValueError``); an unknown arch raises."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_arch(ARCH, reduced=True))


def test_lm_modules_import_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.models, repro_torch.models.convert\n"
        "import repro_torch.launch.serve, repro_torch.kernels.flash_attention\n"
        "import repro_torch.configs.internlm2_1p8b, repro_torch.configs.xlstm_350m\n"
        "import repro_torch.configs.glm4_9b, repro_torch.configs.stablelm_3b\n"
        "import repro_torch.configs.qwen3_14b, repro_torch.configs.zamba2_2p7b\n"
        "import repro_torch.configs.qwen2_moe_a2p7b, repro_torch.configs.grok1_314b\n"
        "import repro_torch.configs.internvl2_26b, repro_torch.configs.whisper_tiny\n"
        "import repro_torch.models.layers, repro_torch.models.transformer\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.models.ssm, repro_torch.kernels.ssd_scan\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""
