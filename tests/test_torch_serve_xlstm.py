"""The PyTorch port's serving loop on the reduced ``xlstm-350m``, on the
CPU, with slot refills: the recurrent-cache twin of
``tests/test_torch_serve.py``.

* ``requests``, ``decode_steps`` and ``total_tokens`` equal the JAX
  ``serve.main``'s on the same arguments (the drain included).
* The token streams equal a serve loop on the JAX model API with the slot's
  recurrent state inserted at **every** layer (the reference's own loop
  inserts layer 0 only, ROADMAP Queue 3), on the port's weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import XLstmCache, build_model
from test_torch_serve import _model_api_loop

ARCH = "xlstm-350m"
# (requests, slots, prompt-len, max-new, cache-len): refills every slot
# twice; the second case runs out of cache and drains. Prompts of 16 tokens
# take the chunked program (chunk 16), of 12 the sequential scan.
CASES = [(6, 2, 16, 6, 40), (6, 2, 12, 6, 24)]


def _argv(requests, slots, prompt_len, max_new, cache_len, seed=0):
    return ["--arch", ARCH, "--reduced", "--requests", str(requests), "--slots", str(slots),
            "--prompt-len", str(prompt_len), "--max-new", str(max_new),
            "--cache-len", str(cache_len), "--seed", str(seed)]


def _arrays_from_params(model):
    """The port's parameters as the reference's pytree (f32 numpy): pairs
    stacked on a leading axis, ``nn.Linear`` weights transposed back."""
    def np32(t):
        return t.detach().float().numpy()

    def stack(get):
        return np.stack([np32(get(b)) for b in model.blocks])

    mlstm = {n: stack(lambda b, n=n: getattr(b.mlstm, n).weight.t())
             for n in ("up_proj", "wq", "wk", "wv", "w_if", "down_proj")}
    mlstm.update({n: stack(lambda b, n=n: getattr(b.mlstm, n)) for n in ("b_if", "norm_g")})
    slstm = {n: stack(lambda b, n=n: getattr(b.slstm, n).weight.t())
             for n in ("w_in", "out_proj")}
    slstm.update({n: stack(lambda b, n=n: getattr(b.slstm, n)) for n in ("r", "b", "norm_g")})
    stage = {"mlstm": {"ln": stack(lambda b: b.mlstm_ln), "mixer": mlstm},
             "slstm": {"ln": stack(lambda b: b.slstm_ln), "mixer": slstm}}
    return {"embed": np32(model.embed.weight), "final_norm": np32(model.final_norm),
            "lm_head": np32(model.lm_head.weight.t()), "stages": (stage,)}


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

    cfg = get_arch(ARCH, reduced=True)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, _arrays_from_params(model))
    assert stats["tokens"] == _model_api_loop(params, *case, arch=ARCH)
    assert sum(len(t) for t in stats["tokens"].values()) == got["total_tokens"]


def test_insert_cache_writes_every_layer_of_every_field():
    model = build_model(get_arch(ARCH, reduced=True), "cpu")
    big = model.init_cache(3, 8)
    small = XLstmCache(*(torch.rand((f.shape[0], 1) + f.shape[2:]) for f in big))
    before = [f.clone() for f in big]
    serve.insert_cache(big, small, 1)
    for got, src, old in zip(big, small, before):
        assert torch.equal(got[:, 1], src[:, 0])
        assert torch.equal(got[:, 0], old[:, 0]) and torch.equal(got[:, 2], old[:, 2])
