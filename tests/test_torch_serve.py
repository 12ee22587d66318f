"""The PyTorch port's serving driver (``repro_torch.launch.serve``) on the
reduced ``internlm2-1.8b``, on the CPU, with slot refills.

* The counts that do not depend on token values — ``requests``,
  ``decode_steps``, ``total_tokens`` — equal the JAX ``serve.main``'s on the
  same arguments (the drain included).
* The token streams equal a serve loop built here from the JAX model's
  ``prefill``/``decode_step`` on the port's weights, with the slot's cache
  inserted at **every** layer. The reference's own loop inserts layer 0 only
  (ROADMAP Queue 3), so its tokens after a refill are not the model's; the
  port is held against the model API instead.
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
from repro_torch.models import KVCache, build_model

ARCH = "internlm2-1.8b"
# (requests, slots, prompt-len, max-new, cache-len): refills every slot
# twice; the second case runs out of cache and drains
CASES = [(6, 2, 8, 6, 32), (6, 2, 8, 6, 20)]


def _argv(requests, slots, prompt_len, max_new, cache_len, seed=0):
    return ["--arch", ARCH, "--reduced", "--requests", str(requests), "--slots", str(slots),
            "--prompt-len", str(prompt_len), "--max-new", str(max_new),
            "--cache-len", str(cache_len), "--seed", str(seed)]


def _arrays_from_params(model):
    """The port's parameters as the reference's pytree (f32 numpy): layers
    stacked on a leading axis, ``nn.Linear`` weights transposed back."""
    def np32(t):
        return t.detach().float().numpy()

    blocks = model.blocks
    stage = {
        "ln1": np.stack([np32(b.ln1) for b in blocks]),
        "attn": {n: np.stack([np32(getattr(b.attn, n).weight.t()) for b in blocks])
                 for n in ("wq", "wk", "wv", "wo")},
        "ln2": np.stack([np32(b.ln2) for b in blocks]),
        "mlp": {n: np.stack([np32(getattr(b.mlp, n).weight.t()) for b in blocks])
                for n in ("w_gate", "w_up", "w_down")},
    }
    return {"embed": np32(model.embed.weight), "final_norm": np32(model.final_norm),
            "lm_head": np32(model.lm_head.weight.t()), "stages": (stage,)}


def _model_api_loop(params, requests, slots, prompt_len, max_new, cache_len, seed=0,
                    arch=ARCH):
    """The serve loop on the JAX model API, every layer inserted: request id
    -> generated tokens."""
    cfg = jget_arch(arch, reduced=True)
    model = jbuild(cfg)
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int32)
             for _ in range(requests)]
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, cache_len=cache_len))
    decode = jax.jit(model.decode_step)
    cache = model.init_cache(slots, cache_len)
    slot_req, remaining = [-1] * slots, [0] * slots
    cur = np.zeros((slots, 1), np.int32)
    tokens, pos, nxt_req, completed = {}, prompt_len, 0, 0

    def fill(slot, cache):
        nonlocal nxt_req
        rid, nxt_req = nxt_req, nxt_req + 1
        logits, small = prefill(params, jnp.asarray(queue[rid][None]))
        tok = int(jnp.argmax(logits[0, -1]))
        tokens[rid], slot_req[slot], remaining[slot] = [tok], rid, max_new - 1
        cur[slot, 0] = tok
        return jax.tree_util.tree_map(lambda b, s: b.at[:, slot].set(s[:, 0]), cache, small)

    for s in range(slots):
        if nxt_req < requests:
            cache = fill(s, cache)
    while completed < requests:
        logits, cache = decode(params, jnp.asarray(cur), cache, jnp.asarray(pos, jnp.int32))
        pos += 1
        nxt = np.asarray(jnp.argmax(logits[:, 0], -1))
        cur[:, 0] = nxt
        for s in range(slots):
            rid = slot_req[s]
            if rid < 0:
                continue
            tokens[rid].append(int(nxt[s]))
            remaining[s] -= 1
            if remaining[s] <= 0:
                completed += 1
                slot_req[s] = -1
                if nxt_req < requests:
                    cache = fill(s, cache)
        if pos + 1 >= cache_len:
            completed += sum(r >= 0 for r in slot_req)
            break
    return tokens


@pytest.mark.parametrize("case", CASES)
def test_serve_counts_and_tokens_match_the_reference(case, capsys):
    stats = {}
    got = serve.main(_argv(*case) + ["--device", "cpu"], stats=stats)
    want = jserve.main(_argv(*case))
    out = capsys.readouterr().out
    assert out.count("[serve] done:") == 2
    assert set(got) == set(want)
    for key in ("arch", "requests", "decode_steps", "total_tokens"):
        assert got[key] == want[key], key
    assert len(stats["prefill_s"]) == case[0]
    assert len(stats["decode_s"]) == got["decode_steps"]

    # the port's weights, as serve draws them, carried into the JAX model
    cfg = get_arch(ARCH, reduced=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, _arrays_from_params(model))
    assert stats["tokens"] == _model_api_loop(params, *case)
    assert sum(len(t) for t in stats["tokens"].values()) == got["total_tokens"]


def test_insert_cache_writes_every_layer():
    big = KVCache(torch.zeros(3, 2, 5, 1, 2), torch.zeros(3, 2, 5, 1, 2))
    small = KVCache(torch.arange(30.0).reshape(3, 1, 5, 1, 2),
                    -torch.arange(30.0).reshape(3, 1, 5, 1, 2))
    serve.insert_cache(big, small, 1)
    assert torch.equal(big.k[:, 1], small.k[:, 0])
    assert torch.equal(big.v[:, 1], small.v[:, 0])
    assert not big.k[:, 0].any() and not big.v[:, 0].any()


def test_serve_refuses_a_cache_too_short():
    with pytest.raises(ValueError, match="cache-len"):
        serve.main(_argv(2, 1, 8, 6, 12) + ["--device", "cpu"])
