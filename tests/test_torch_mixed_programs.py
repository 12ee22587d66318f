"""Block programs that mix block types, and standalone ``mamba2``,
``mlstm``, ``slstm`` and ``enc`` stages, in the PyTorch port against the
JAX model API (``ArchConfig.stages``), at the reduced configs, f32.

One tree of seed-made numpy weights (the reference's init distributions,
drawn by the port's ``init`` from ``torch.Generator().manual_seed(i)`` and
laid out as the reference's tree by ``params_to_arrays``, whose paths and
shapes are held to the reference's ``init``) goes into both models: into
the port's through ``convert.params_from_arrays``. Token inputs come from
a seeded numpy generator. For each program:

- forward logits and the MoE aux loss;
- prefill logits (cache ``CACHE``) and every field of every stage's cache;
- two decode steps, the first at an int position, the second at a ``[B]``
  tensor of positions (each row's own indices and mask), logits and caches;
- the loss (cross entropy plus the MoE aux over every stage);
- one SGD step: its metrics and every reference leaf after it;
- ``params_to_arrays`` giving back the tree, leaf for leaf, with the
  paths, shapes and dtypes of the reference's ``init``;
- a reduced ``launch/serve.main(config=...)`` run on both position modes,
  each request on ``--per-slot-positions`` equal to its own greedy
  prefill + decode.

Tolerances are those of ``tests/test_torch_lm.py`` and
``test_torch_zamba2.py``: logits atol/rtol 1e-4 with the same greedy
tokens, caches and weights 1e-5 (a cache field to rtol 1e-5 plus 1e-5 of
its largest magnitude, as the train tests hold a weight to 1e-5 of its
leaf's largest entry: an mLSTM state sums chunks of outer products, whose
f32 order differs between the frameworks, into entries near 10); losses
and step metrics rel 1e-5. Each
program's JAX model, parameters and results are built once a process; the
port's side runs on one intra-op thread. The zamba2 and xLSTM programs
run in ``test_torch_mixed_programs_recurrent.py`` (the checks are these
functions), so that each file stays short.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_arrays, params_to_arrays, reference_leaves
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

# (arch, stages): every program the reference runs on one device at these
# reduced configs
PROGRAMS = (
    ("internlm2-1.8b", (("dense", 1), ("mamba2", 2))),
    ("internlm2-1.8b", (("mlstm", 1), ("slstm", 1), ("dense", 1))),
    ("internlm2-1.8b", (("dense", 1), ("enc", 1))),
    ("internlm2-1.8b", (("mamba2", 2),)),
    ("zamba2-2.7b", (("zamba_super", 1), ("dense", 1))),
    ("zamba2-2.7b", (("mamba2", 2), ("dense", 1))),
    ("xlstm-350m", (("mlstm", 2),)),
    ("xlstm-350m", (("slstm", 1),)),
    ("xlstm-350m", (("mlstm", 1), ("slstm", 1), ("xlstm_pair", 1))),
    ("qwen2-moe-a2.7b", (("dense", 1), ("moe", 2))),
    ("qwen2-moe-a2.7b", (("moe", 1), ("mamba2", 1))),
)
IDS = [f"{arch}:" + "+".join(f"{t}{n}" for t, n in stages) for arch, stages in PROGRAMS]
B, PROMPT, CACHE = 2, 16, 24  # PROMPT a multiple of the xLSTM's and zamba2's chunk
TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_REL = 1e-5
REL = 1e-5
SGD_LR = 0.5
# serve: 5 requests on 2 slots (3 refill a freed slot), prompts of 8
SERVE = dict(requests=5, slots=2, prompt=8, max_new=4, cache=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(i):
    arch, stages = PROGRAMS[i]
    return (get_arch(arch, reduced=True).replace(stages=stages),
            jget_arch(arch, reduced=True).replace(stages=stages))


def _tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


@functools.lru_cache(maxsize=None)
def reference(i):
    """The JAX model, its parameters (numpy too) and every result the
    checks read, computed once a process."""
    cfg, jcfg = _configs(i)
    jmodel = jbuild(jcfg)
    tree = params_to_arrays(build_model(cfg, "cpu").init(torch.Generator().manual_seed(i)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(i)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    batch = tokens.copy()
    batch[1, 5] = -1  # a masked target
    out = dict(jmodel=jmodel, params=params, tree=tree, tokens=tokens, batch=batch)
    out["logits"], out["aux"] = jax.jit(jmodel.forward)(params, {"tokens": jnp.asarray(tokens)})
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, cache_len=CACHE))
    decode = jax.jit(jmodel.decode_step)
    last, caches = prefill(params, jnp.asarray(tokens))
    steps = [(last, caches)]
    tok = jnp.argmax(last[:, -1], -1)[:, None].astype(jnp.int32)
    for k in range(2):
        last, caches = decode(params, tok, caches, jnp.asarray(PROMPT + k, jnp.int32))
        steps.append((last, caches))
        tok = jnp.argmax(last[:, 0], -1)[:, None].astype(jnp.int32)
    out["steps"] = [(np.asarray(lg), jax.tree_util.tree_map(np.asarray, c)) for lg, c in steps]
    sgd = jopt.sgd(lr=SGD_LR)
    jstep = jax.jit(jts.make_train_step(jmodel, sgd, jts.TrainStepConfig()))
    out["p1"], _, out["metrics"] = jstep(params, sgd.init(params),
                                         {"tokens": jnp.asarray(batch)})
    return out


@functools.lru_cache(maxsize=None)
def port(i):
    return params_from_arrays(_configs(i)[0], reference(i)["tree"], "cpu")


def _jax_fields(btype, stage):
    """A reference stage cache's fields in the port's order (zamba2's
    Mamba-2 fields ``[P, M, ...]`` as ``[P*M, ...]``)."""
    if stage is None:
        return []
    if btype == "zamba_super":
        h, (cx, cbc) = stage["mamba"]
        return [a.reshape(-1, *a.shape[2:]) for a in (h, cx, cbc)] + list(stage["attn"])
    if btype == "xlstm_pair":
        return list(stage["mlstm"]) + list(stage["slstm"])
    if btype == "mamba2":
        h, (cx, cbc) = stage
        return [h, cx, cbc]
    return list(stage)


def _assert_caches_close(model, cache, jcaches, what):
    ours = model.stage_caches(cache)
    assert len(ours) == len(jcaches) == len(model.program)
    for (btype, _), mine, theirs in zip(model.program, ours, jcaches):
        want = _jax_fields(btype, theirs)
        got = [] if mine is None else list(mine)
        assert len(got) == len(want), (what, btype)
        for f, (g, w) in enumerate(zip(got, want)):
            assert tuple(g.shape) == w.shape, (what, btype, f)
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"{what} {btype} field {f}",
                                       rtol=CACHE_REL,
                                       atol=CACHE_REL * float(np.abs(w).max(initial=0.0)))


def _assert_rel(got, want, what):
    assert abs(float(got) - float(want)) <= REL * max(abs(float(want)), 1e-12), (what, got,
                                                                                  want)


# ---------------------------------------------- the checks, for each program

def forward_matches(i):
    r = reference(i)
    logits, aux = port(i)(torch.from_numpy(r["tokens"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(r["logits"]), **TOL)
    _assert_rel(aux, r["aux"], "aux")
    if not any(t == "moe" for t, _ in PROGRAMS[i][1]):
        assert float(aux) == 0.0


def prefill_and_two_decode_steps_match(i):
    """The prefill, a decode step at an int position, then one at a ``[B]``
    tensor of positions; logits, greedy tokens and every cache field."""
    r = reference(i)
    model = port(i)
    logits, cache = model.prefill(torch.from_numpy(r["tokens"]), cache_len=CACHE)
    if len(model.program) == 1:
        assert not isinstance(cache, tuple) or hasattr(cache, "_fields")
    for k, (want, jcaches) in enumerate(r["steps"]):
        what = f"step {k}"
        np.testing.assert_allclose(logits.numpy(), want, err_msg=what, **TOL)
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), want[:, -1].argmax(-1))
        _assert_caches_close(model, cache, jcaches, what)
        if k == 2:
            break
        tok = torch.from_numpy(want[:, -1].argmax(-1)).long()[:, None]
        pos = PROMPT if k == 0 else torch.full((B,), PROMPT + 1, dtype=torch.int64)
        logits, cache = model.decode_step(tok, cache, pos)


def loss_and_one_sgd_step_match(i):
    r = reference(i)
    model = params_from_arrays(_configs(i)[0], r["tree"], "cpu")
    batch = {"tokens": r["batch"]}
    with torch.no_grad():
        total, m = model.loss({"tokens": torch.from_numpy(r["batch"])})
    _assert_rel(total, r["metrics"]["loss"], "loss")
    for key in ("ce", "aux", "tokens"):
        _assert_rel(m[key], r["metrics"][key], key)
    opt = topt.sgd(lr=SGD_LR)
    state, m = tts.make_train_step(model, opt)(tts.init_opt_state(model, opt), batch)
    assert sorted(m) == sorted(r["metrics"])
    for key in ("loss", "ce", "aux", "grad_norm", "tokens"):
        _assert_rel(m[key], r["metrics"][key], f"step {key}")
    want = jax.tree_util.tree_flatten_with_path(_tree_np(r["p1"]))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(params_to_arrays(model))[0])
    assert len(got) == len(want)
    for path, w in want:
        g = got[path]
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        tol = REL * float(np.max(np.abs(w), initial=0.0))
        assert float(np.max(np.abs(g - w), initial=0.0)) <= tol, jax.tree_util.keystr(path)


def params_round_trip_to_the_reference_tree(i):
    """``params_to_arrays`` of the loaded model gives the tree back, leaf
    for leaf, in the reference's pytree order with the paths, shapes and
    dtypes of the reference's own ``init``; the ``reference_leaves`` are in
    that order."""
    r = reference(i)
    shapes = jax.eval_shape(r["jmodel"].init, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_flatten_with_path(shapes)[0]
    given = jax.tree_util.tree_flatten_with_path(r["tree"])[0]
    got = jax.tree_util.tree_flatten_with_path(params_to_arrays(port(i)))[0]
    assert [p for p, _ in got] == [p for p, _ in given] == [p for p, _ in want]
    for (path, g), (_, v), (_, w) in zip(got, given, want):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.array_equal(g, v), name
    assert [leaf.shape for leaf in reference_leaves(port(i))] == [w.shape for _, w in want]


def serve_runs_the_program(i):
    """``serve.main(config=...)`` on the shared counter and per slot; per
    slot, every request (the refills too) is its own greedy prefill +
    decode on the port."""
    cfg = _configs(i)[0]
    argv = ["--requests", str(SERVE["requests"]), "--slots", str(SERVE["slots"]),
            "--prompt-len", str(SERVE["prompt"]), "--max-new", str(SERVE["max_new"]),
            "--cache-len", str(SERVE["cache"]), "--seed", "0", "--device", "cpu"]
    shared = serve.main(argv, config=cfg)
    stats = {}
    result = serve.main(argv + ["--per-slot-positions"], stats=stats, config=cfg)
    assert shared["requests"] == result["requests"] == SERVE["requests"]
    assert 0 < shared["total_tokens"] <= result["total_tokens"]  # the counter drains
    assert result["total_tokens"] == SERVE["requests"] * SERVE["max_new"]
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    for rid in range(SERVE["requests"]):
        prompt = rng.integers(0, cfg.vocab_size, size=SERVE["prompt"]).astype(np.int32)
        logits, cache = model.prefill(torch.from_numpy(prompt[None]).long(),
                                      cache_len=SERVE["cache"])
        toks = [int(logits[0, -1].argmax())]
        for k in range(SERVE["max_new"] - 1):
            logits, cache = model.decode_step(torch.tensor([[toks[-1]]]), cache,
                                              SERVE["prompt"] + k)
            toks.append(int(logits[0, 0].argmax()))
        assert stats["tokens"][rid] == toks, rid


CHECKS = (forward_matches, prefill_and_two_decode_steps_match, loss_and_one_sgd_step_match,
          params_round_trip_to_the_reference_tree, serve_runs_the_program)
HERE = tuple(i for i, (arch, _) in enumerate(PROGRAMS)
             if arch in ("internlm2-1.8b", "qwen2-moe-a2.7b"))


@pytest.mark.parametrize("check", CHECKS, ids=[c.__name__ for c in CHECKS])
@pytest.mark.parametrize("i", HERE, ids=[IDS[i] for i in HERE])
def test_program(i, check):
    check(i)


# ------------------------------------------------------- structure, checks

def test_stages_caches_and_the_shared_block():
    """One ``ModuleList`` a stage in program order; a one-stage program
    keeps its stage's cache type, a program of more stages has a tuple
    parallel to it (None for ``enc``); ``shared_attn`` only with a
    ``zamba_super`` stage."""
    def model(i):
        return build_model(_configs(i)[0], "cpu")

    zamba = model(4)  # zamba_super + dense
    assert [t for t, _ in zamba.stages] == ["zamba_super", "dense"]
    assert [type(b) for b in zamba.stages[1][1]] == [T.DenseBlock]
    assert zamba.shared_attn is not None and model(5).shared_attn is None
    cache = model(2).init_cache(1, 8)  # dense + enc
    assert isinstance(cache, tuple) and isinstance(cache[0], T.KVCache) and cache[1] is None
    for i, kind in ((3, T.Mamba2Cache), (6, T.MLstmCache), (7, T.SLstmCache)):
        c = model(i).init_cache(2, 8)
        assert type(c) is kind and c[0].shape[0] == PROGRAMS[i][1][0][1]
    assert float(model(7).init_cache(1, 8).m.max()) == -10.0
    assert len(model(8).blocks) == 3 and len(model(8).init_cache(1, 8)) == 3


def test_unknown_block_type_raises_value_error():
    cfg = get_arch("internlm2-1.8b", reduced=True)
    with pytest.raises(ValueError, match="unknown block type conv"):
        build_model(cfg.replace(stages=(("dense", 1), ("conv", 1))), "cpu")


def test_convert_checks_every_stage_against_the_program():
    r = reference(0)  # dense + mamba2
    cfg = _configs(0)[0]
    tree = r["tree"]
    with pytest.raises(ValueError, match="1 stages, the config's program 2"):
        params_from_arrays(cfg, dict(tree, stages=tree["stages"][:1]), "cpu")
    swapped = dict(tree, stages=tree["stages"][::-1])
    with pytest.raises(ValueError, match=r"stages\[0\] is not a 'dense' stage"):
        params_from_arrays(cfg, swapped, "cpu")
    short = jax.tree_util.tree_map(lambda a: a[:1], tree["stages"][1])
    with pytest.raises(ValueError, match=r"stages\[1\] holds 1 layers, the config 2"):
        params_from_arrays(cfg, dict(tree, stages=(tree["stages"][0], short)), "cpu")
