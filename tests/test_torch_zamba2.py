"""The PyTorch port's hybrid ``zamba2-2.7b`` (reduced: 2 super-blocks of 2
Mamba-2 layers and the weight-tied shared attention block, d 64, f32)
against the JAX reference on the same parameters.

The reference's parameters come across with ``convert.params_from_arrays``;
inputs come from numpy with a fixed seed. Forward, prefill and decode
logits agree to 1e-4 (the two frameworks differ only in summation order,
which the recurrences carry across steps) with identical greedy tokens,
and the caches to 1e-5: 8 decode steps at an int position, and at a ``[B]``
tensor of positions against each row's sequence decoded alone (the
reference's ``decode_step`` takes one position). Prompts of 32 tokens take
the chunked GLA program (chunk 16), of 13 the sequential scan. The serve
loop with ``--per-slot-positions`` gives every request, refills included,
its own greedy tokens on the JAX model API.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import ZambaCache, build_model
from repro_torch.models.convert import params_from_arrays

ARCH = "zamba2-2.7b"
N_DECODE = 8
PROMPT, CACHE = 32, 48
TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
# serve: 6 requests on 2 slots (every slot refilled twice), prompts of 16
REQUESTS, SLOTS, SERVE_PROMPT, MAX_NEW, SERVE_CACHE = 6, 2, 16, 6, 48
_MAMBA_LINEAR = ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj")
_MAMBA_ARRAY = ("conv_w_x", "conv_b_x", "conv_w_bc", "conv_b_bc", "A_log", "D", "dt_bias",
                "norm_g")


def _tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _tokens(b, s, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def ref():
    """(JAX model, JAX params, the params as f32 numpy, the port's model on
    them)."""
    jmodel = jbuild(jget_arch(ARCH, reduced=True))
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = _tree_np(params)
    return jmodel, params, tree, params_from_arrays(get_arch(ARCH, reduced=True), tree, "cpu")


def _jit(jmodel, cache_len):
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=cache_len))
    return prefill, jax.jit(jmodel.decode_step)


def _cache_close(cache: ZambaCache, jcache):
    """The port's layer-first cache against the reference's stage cache
    (Mamba-2 fields ``[P, M, ...]``, attention ``[P, ...]``)."""
    (stage,) = jcache
    jh, (jcx, jcbc) = stage["mamba"]
    jk, jv = stage["attn"]
    for got, want in ((cache.mamba_h, jh), (cache.conv_x, jcx), (cache.conv_bc, jcbc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want.reshape(-1, *want.shape[2:]), **CACHE_TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jk), **CACHE_TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jv), **CACHE_TOL)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("reduced", [False, True])
def test_config_copies_the_reference(reduced):
    cfg, jcfg = get_arch(ARCH, reduced=reduced), jget_arch(ARCH, reduced=reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.block_program() == jcfg.block_program() == (
        ("zamba_super", 2 if reduced else 9),)
    if reduced:
        assert (cfg.gla_chunk, cfg.mamba_per_super) == (16, 2)


def test_cache_shapes_match_block_cache(ref):
    jmodel, _, _, model = ref
    cache = model.init_cache(3, 20)
    (stage,) = jmodel.init_cache(3, 20)
    jh, (jcx, jcbc) = stage["mamba"]
    for got, want in ((cache.mamba_h, jh), (cache.conv_x, jcx), (cache.conv_bc, jcbc)):
        assert got.shape == (want.shape[0] * want.shape[1], *want.shape[2:])
        assert got.dtype == torch.float32 and not got.any()
    for got, want in zip(cache[3:], stage["attn"]):
        assert got.shape == want.shape and got.dtype == torch.float32


# ---------------------------------------------------------------- parameters

def test_n_params_counts_the_shared_block_once(ref):
    jmodel, params, tree, model = ref
    assert model.n_params() == jmodel.n_params(params)
    keys = list(model.state_dict())
    shared = [k for k in keys if k.startswith("shared_attn.")]
    assert len(shared) == 9 and not any(".shared_attn." in k for k in keys)
    sh = tree["shared_attn"]
    np.testing.assert_array_equal(model.shared_attn.ln1.numpy(), sh["ln1"])
    np.testing.assert_array_equal(model.shared_attn.ln2.numpy(), sh["ln2"])
    for n in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(getattr(model.shared_attn.attn, n).weight.numpy().T,
                                      sh["attn"][n])
    for n in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(getattr(model.shared_attn.mlp, n).weight.numpy().T,
                                      sh["mlp"][n])
    mamba = tree["stages"][0]["mamba"]
    for i, block in enumerate(model.blocks):
        for m, layer in enumerate(block.mamba):
            np.testing.assert_array_equal(layer.ln.numpy(), mamba["ln"][i, m])
            for n in _MAMBA_LINEAR:
                np.testing.assert_array_equal(getattr(layer.mixer, n).weight.numpy().T,
                                              mamba["mixer"][n][i, m])
            for n in _MAMBA_ARRAY:
                np.testing.assert_array_equal(getattr(layer.mixer, n).numpy(),
                                              mamba["mixer"][n][i, m])


def test_init_draws_every_block_and_the_shared_one_once():
    cfg = get_arch(ARCH, reduced=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    again = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    w = [b.mamba[0].mixer.z_proj.weight for b in model.blocks]
    assert not torch.equal(w[0], w[1])
    assert abs(float(model.shared_attn.attn.wq.weight.std()) - (1 / 64) ** 0.5) < 0.02


def test_convert_rejects_a_stage_of_another_shape(ref):
    _, _, tree, _ = ref
    cfg = get_arch(ARCH, reduced=True)
    stage = tree["stages"][0]
    short = dict(tree, stages=(jax.tree_util.tree_map(lambda a: a[:1], stage),))
    with pytest.raises(ValueError, match="1 layers, the config 2"):
        params_from_arrays(cfg, short, "cpu")
    thin = dict(tree, stages=(jax.tree_util.tree_map(lambda a: a[:, :1], stage),))
    with pytest.raises(ValueError, match="1 Mamba-2 layers a super-block, the config 2"):
        params_from_arrays(cfg, thin, "cpu")


# ---------------------------------------------------------------- model

def test_forward_matches(ref):
    jmodel, params, _, model = ref
    cfg = get_arch(ARCH, reduced=True)
    tokens = _tokens(2, PROMPT, cfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(params, {"tokens": jnp.asarray(tokens)})
    got, aux = model(torch.from_numpy(tokens))
    assert got.shape == (2, PROMPT, cfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_int_position_decode_match(ref):
    jmodel, params, _, model = ref
    cfg = get_arch(ARCH, reduced=True)
    prefill, decode = _jit(jmodel, CACHE)
    tokens = _tokens(2, PROMPT, cfg.vocab_size)
    want, jcache = prefill(params, jnp.asarray(tokens))
    got, cache = model.prefill(torch.from_numpy(tokens), cache_len=CACHE)
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
    """Prompts of 13 (the sequential scan) and 32 tokens (the chunked
    program), each prefilled alone and inserted into a batch of 2; 8 steps
    at ``[B]`` positions, each row against its own sequence on the JAX
    model API."""
    jmodel, params, _, model = ref
    cfg = get_arch(ARCH, reduced=True)
    prefill, decode = _jit(jmodel, CACHE)
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


# ---------------------------------------------------------------- serve

def _arrays_from_params(model):
    """The port's parameters as the reference's pytree (f32 numpy): Mamba-2
    layers stacked ``[P, M, ...]``, the shared block unstacked,
    ``nn.Linear`` weights transposed back."""
    def np32(t):
        return t.detach().float().numpy()

    def stack(get):
        return np.stack([np.stack([np32(get(layer)) for layer in b.mamba])
                         for b in model.blocks])

    mixer = {n: stack(lambda l, n=n: getattr(l.mixer, n).weight.t()) for n in _MAMBA_LINEAR}
    mixer.update({n: stack(lambda l, n=n: getattr(l.mixer, n)) for n in _MAMBA_ARRAY})
    sh = model.shared_attn
    shared = {"ln1": np32(sh.ln1), "ln2": np32(sh.ln2),
              "attn": {n: np32(getattr(sh.attn, n).weight.t()) for n in ("wq", "wk", "wv", "wo")},
              "mlp": {n: np32(getattr(sh.mlp, n).weight.t())
                      for n in ("w_gate", "w_up", "w_down")}}
    return {"embed": np32(model.embed.weight), "final_norm": np32(model.final_norm),
            "lm_head": np32(model.lm_head.weight.t()),
            "stages": ({"mamba": {"ln": stack(lambda l: l.ln), "mixer": mixer}},),
            "shared_attn": shared}


def test_serve_per_slot_positions_gives_every_request_its_own_tokens():
    stats = {}
    argv = ["--arch", ARCH, "--reduced", "--requests", str(REQUESTS), "--slots", str(SLOTS),
            "--prompt-len", str(SERVE_PROMPT), "--max-new", str(MAX_NEW),
            "--cache-len", str(SERVE_CACHE), "--seed", "0", "--device", "cpu",
            "--per-slot-positions"]
    result = serve.main(argv, stats=stats)
    assert (result["arch"], result["requests"], result["decode_steps"],
            result["total_tokens"]) == (ARCH, REQUESTS, 3 * (MAX_NEW - 1), REQUESTS * MAX_NEW)

    cfg = get_arch(ARCH, reduced=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, _arrays_from_params(model))
    jmodel = jbuild(jget_arch(ARCH, reduced=True))
    assert jmodel.n_params(params) == model.n_params()
    prefill, decode = _jit(jmodel, SERVE_CACHE)
    rng = np.random.default_rng(0)
    for rid in range(REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, size=SERVE_PROMPT).astype(np.int32)
        logits, cache = prefill(params, jnp.asarray(prompt[None]))
        toks = [int(jnp.argmax(logits[0, -1]))]
        for i in range(MAX_NEW - 1):
            logits, cache = decode(params, jnp.asarray([[toks[-1]]], jnp.int32), cache,
                                   jnp.asarray(SERVE_PROMPT + i, jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        assert stats["tokens"][rid] == toks, rid


def test_insert_cache_writes_every_field_of_every_layer():
    model = build_model(get_arch(ARCH, reduced=True), "cpu")
    big = model.init_cache(3, 8)
    small = ZambaCache(*(torch.rand((f.shape[0], 1) + f.shape[2:]) for f in big))
    before = [f.clone() for f in big]
    serve.insert_cache(big, small, 1)
    for got, src, old in zip(big, small, before):
        assert torch.equal(got[:, 1], src[:, 0])
        assert torch.equal(got[:, 0], old[:, 0]) and torch.equal(got[:, 2], old[:, 2])
