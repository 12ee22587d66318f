"""Per-slot decode positions in the port's serve loop
(``repro_torch.launch.serve --per-slot-positions``), on the CPU, with the
reduced configs: seed 0, 6 requests, 2 slots, prompts of 16 tokens, 6 new
tokens, cache 48, so every slot is refilled twice.

* With the flag, every internlm2 request, refills included, equals its own
  single-sequence greedy prefill + decode on the JAX model API (the port's
  weights carried across); also with a cache so short that an idle slot's
  position would pass its end. Without it, the refills decode at the
  batch's shared position (the reference's loop, ROADMAP Queue 3) and
  differ.
* ``decode_step`` with a ``[B]`` tensor of positions equals each row
  decoded alone at its int position.
* The xLSTM has no positions: the flag leaves its tokens as they are.
* Without the flag the loop is the reference's: its counts equal the JAX
  ``serve.main``'s and its tokens the shared-counter loop on the model API.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import build_model
from test_torch_serve import _arrays_from_params, _model_api_loop

ARCH = "internlm2-1.8b"
REQUESTS, SLOTS, PROMPT, MAX_NEW, CACHE = 6, 2, 16, 6, 48
FLAG = "--per-slot-positions"


def _argv(arch=ARCH, requests=REQUESTS, cache_len=CACHE):
    return ["--arch", arch, "--reduced", "--requests", str(requests),
            "--slots", str(SLOTS), "--prompt-len", str(PROMPT), "--max-new", str(MAX_NEW),
            "--cache-len", str(cache_len), "--seed", "0"]


def _serve(*extra, **kw):
    stats = {}
    result = serve.main(_argv(**kw) + ["--device", "cpu", *extra], stats=stats)
    return result, stats["tokens"]


@pytest.fixture(scope="module")
def jax_params():
    """The port's internlm2 weights as serve draws them (seed 0), as the
    reference's pytree."""
    model = build_model(get_arch(ARCH, reduced=True), "cpu").init(
        torch.Generator().manual_seed(0))
    return jax.tree_util.tree_map(jnp.asarray, _arrays_from_params(model))


def _own_greedy_tokens(params, requests=REQUESTS, cache_len=CACHE):
    """Request id -> the request's own greedy prefill + decode, one sequence
    at a time, on the JAX model API."""
    cfg = jget_arch(ARCH, reduced=True)
    model = jbuild(cfg)
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, cache_len=cache_len))
    decode = jax.jit(model.decode_step)
    rng = np.random.default_rng(0)
    out = {}
    for rid in range(requests):
        prompt = rng.integers(0, cfg.vocab_size, size=PROMPT).astype(np.int32)
        logits, cache = prefill(params, jnp.asarray(prompt[None]))
        toks = [int(jnp.argmax(logits[0, -1]))]
        for i in range(MAX_NEW - 1):
            logits, cache = decode(params, jnp.asarray([[toks[-1]]], jnp.int32), cache,
                                   jnp.asarray(PROMPT + i, jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        out[rid] = toks
    return out


@pytest.fixture(scope="module")
def own_tokens(jax_params):
    return _own_greedy_tokens(jax_params)


def test_per_slot_positions_give_every_request_its_own_greedy_tokens(own_tokens):
    result, tokens = _serve(FLAG)
    assert (result["requests"], result["decode_steps"], result["total_tokens"]) == (
        REQUESTS, 3 * (MAX_NEW - 1), REQUESTS * MAX_NEW)
    assert tokens == own_tokens


def test_an_idle_slot_stays_inside_a_short_cache(jax_params):
    """3 requests on 2 slots, cache 22: after request 1 ends, its idle slot
    steps on while request 2 decodes and would pass position 21; it is held
    there, and every request is still its own greedy run."""
    result, tokens = _serve(FLAG, requests=3, cache_len=22)
    assert (result["requests"], result["decode_steps"], result["total_tokens"]) == (
        3, 2 * (MAX_NEW - 1), 3 * MAX_NEW)
    assert tokens == _own_greedy_tokens(jax_params, requests=3, cache_len=22)


def test_decode_step_with_row_positions_equals_each_row_alone():
    """Three rows at positions 5, 9 and 12, two steps: logits to 1e-5 of
    their largest magnitude (f32; the batched step attends over the whole
    cache with masked keys, the single row over its prefix, so only the
    summation differs), the same greedy tokens, and each row's cache written
    at its own positions only."""
    cfg = get_arch(ARCH, reduced=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    lengths, cache_len = (5, 9, 12), 24
    cache = model.init_cache(len(lengths), cache_len)
    singles, tok = [], []
    with torch.inference_mode():
        for b, n in enumerate(lengths):
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
            logits, small = model.prefill(prompt, cache_len=cache_len)
            serve.insert_cache(cache, small, b)
            singles.append(small)
            tok.append(int(logits[0, -1].argmax()))
        pos = torch.tensor(lengths, dtype=torch.int64)
        cur = torch.tensor(tok)[:, None]
        for step in range(2):
            logits, cache = model.decode_step(cur, cache, pos + step)
            for b, n in enumerate(lengths):
                alone, singles[b] = model.decode_step(cur[b:b + 1], singles[b], n + step)
                scale = float(alone.abs().max())
                torch.testing.assert_close(logits[b:b + 1], alone, rtol=0, atol=1e-5 * scale)
                assert int(logits[b, 0].argmax()) == int(alone[0, 0].argmax())
                for big, small in zip(cache, singles[b]):
                    torch.testing.assert_close(big[:, b, :n + step + 1], small[:, 0, :n + step + 1],
                                               rtol=0, atol=1e-5)
                    assert not big[:, b, n + step + 1:].any()
            cur = logits[:, 0].argmax(-1)[:, None]


def test_flag_leaves_the_xlstm_tokens_as_they_are():
    result, tokens = _serve(arch="xlstm-350m")
    result_flag, tokens_flag = _serve(FLAG, arch="xlstm-350m")
    assert tokens_flag == tokens
    for key in ("requests", "decode_steps", "total_tokens"):
        assert result_flag[key] == result[key]


def test_without_the_flag_the_loop_is_the_reference_shared_counter(
        jax_params, own_tokens, capsys):
    result, tokens = _serve()
    want = jserve.main(_argv())
    capsys.readouterr()
    for key in ("arch", "requests", "decode_steps", "total_tokens"):
        assert result[key] == want[key], key
    assert tokens == _model_api_loop(jax_params, REQUESTS, SLOTS, PROMPT, MAX_NEW, CACHE)
    # the shared counter gets the first two right and every refill wrong
    assert [tokens[r] == own_tokens[r] for r in range(REQUESTS)] == (
        [True] * SLOTS + [False] * (REQUESTS - SLOTS))
