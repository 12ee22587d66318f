"""The port's dry run (``repro_torch.launch.dryrun``, ``launch/shapes.py``'s
builders, ``launch/mesh.py``'s peaks) on the CPU.

* ``lower_cell("whisper-tiny", "decode_32k")`` is ``ok`` with a dominant
  roofline term (the reference's ``test_dryrun_single_cell``), and
  allocates no real tensor of more than 1 MiB while it counts;
* ``flops_computed`` holds to the reference's ``analyze_hlo`` dot FLOPs to
  2 % on a reduced dense and a reduced MoE config, at a short prefill and a
  train step of 2 accumulated microbatches (the reference lowered on one
  CPU device in a subprocess; at S = 32 both take the naive attention
  route);
* ``flops_per_device`` is ``flops_computed`` less the causal mask's hidden
  pairs in closed form (prefill, remat train, plain train), and equals it
  on whisper's unmasked encoder;
* the sLSTM loop and the train step's microbatches counted by their trip
  counts equal the fully stepped counts;
* ``lower_spars_rl(n_envs=8, device="cpu")`` is ``ok``;
* the builders' shapes and ``param_count`` against the reference's (whose
  ``param_count`` wraps in int32 on leaves over 2**31 elements: ROADMAP
  Queue 3), and ``main``'s files, lines and exit codes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO, SRC
from repro.launch.hlo_analysis import roofline_terms as jroofline_terms
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import dryrun, mesh, shapes
from repro_torch.launch.shapes import ShapeSpec

PREFILL = ShapeSpec("prefill_s32", "prefill", 32, 2)
TRAIN = ShapeSpec("train_s32", "train", 32, 4)
ACCUM = 2
HLO_REL = 0.02
ONE_MIB = 1 << 20

_REFERENCE = textwrap.dedent(
    """
    import json
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch, list_archs
    from repro.launch import shapes
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import build_model
    from repro.training.train_step import TrainStepConfig, make_optimizer, make_train_step

    out = {"hlo": {}, "params": {}, "batch": {}, "accum": {}}
    for arch in ("internlm2-1.8b", "qwen2-moe-a2.7b"):
        cfg = get_arch(arch, reduced=True)
        model = build_model(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        toks = lambda b: {"tokens": jax.ShapeDtypeStruct((b, 32), jnp.int32)}
        c = jax.jit(model.prefill).lower(params, toks(2)).compile()
        out["hlo"][arch + "/prefill"] = analyze_hlo(c.as_text(), 1).flops
        opt = make_optimizer(cfg.optimizer, 1e-4)
        step = make_train_step(model, opt, TrainStepConfig(accum_steps=2))
        c = jax.jit(step).lower(params, jax.eval_shape(opt.init, params), toks(4)).compile()
        out["hlo"][arch + "/train"] = analyze_hlo(c.as_text(), 1).flops
    for arch in list_archs():
        cfg = get_arch(arch)
        leaves = jax.tree_util.tree_leaves(
            jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0)))
        n = sum(int(np.prod(x.shape, dtype=np.int64)) for x in leaves)
        biggest = max(int(np.prod(x.shape, dtype=np.int64)) for x in leaves)
        out["params"][arch] = [n, int(shapes.param_count(cfg)), biggest]
        out["batch"][arch] = {
            name: {k: [list(v.shape), str(v.dtype)]
                   for k, v in shapes.batch_specs(cfg, spec).items()}
            for name, spec in shapes.SHAPE_SETS.items()}
        out["accum"][arch] = shapes.train_accum_steps(cfg, n, shapes.SHAPE_SETS["train_4k"])
    print("REFERENCE " + json.dumps(out))
    """
)


@pytest.fixture(scope="module", autouse=True)
def reference_process():
    """The reference's HLO dot FLOPs, parameter counts, batch shapes and
    accumulation, computed by one subprocess on one CPU device, started
    with the module so that it runs beside the port's cases."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=SRC)
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_process):
    out, err = reference_process.communicate(timeout=300)
    assert reference_process.returncode == 0, err
    return json.loads(out.split("REFERENCE ", 1)[1])


def _reduced(arch):
    r = get_arch(arch, reduced=True)
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


@pytest.fixture(scope="module")
def whisper_decode():
    """``lower_cell("whisper-tiny", "decode_32k")`` and the largest real
    allocation any op made while it ran (the CPU profiler's memory)."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        rec = dryrun.lower_cell("whisper-tiny", "decode_32k")
    return rec, max(e.self_cpu_memory_usage for e in prof.events())


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def test_single_cell(whisper_decode):
    rec, _ = whisper_decode
    assert rec["status"] == "ok", rec
    assert rec["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["mesh"] == "1xH100" and rec["n_devices"] == 1
    assert rec["collective_wire_bytes_per_device"] == 0
    assert rec["fits_one_card"] == (rec["args_bytes_per_device"] <= mesh.HBM_BYTES)
    assert rec["peak"]["flops_per_s"] == mesh.PEAK_FLOPS_BF16


def test_counting_allocates_no_real_tensor(whisper_decode):
    _, biggest = whisper_decode
    assert biggest <= ONE_MIB, f"a real allocation of {biggest} bytes"


def test_skipped_cell_gives_its_reason():
    rec = dryrun.lower_cell("internlm2-1.8b", "long_500k")
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]


def test_the_naive_route_counts_as_the_plain_flash_route():
    """Prefill on the plain flash route (the dry run's ``auto``) computes
    the naive route's FLOPs."""
    cfg = get_arch("internlm2-1.8b", reduced=True)
    rec = dryrun.lower_cell("internlm2-1.8b", PREFILL, config_overrides=_reduced("internlm2-1.8b"))
    with shapes.fake_mode():
        model = shapes.fake_model(cfg, attn_impl="naive")
        batch = shapes.batch_specs(cfg, PREFILL)
        _, counter = dryrun.count(model.prefill, batch["tokens"])
    assert counter.flops == rec["flops_computed"]
    assert counter.masked_flops() == rec["attention_masked_flops"]


# ---------------------------------------------------------------------------
# the masked half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,offset", [(1, 1, 0), (5, 5, 0), (3, 9, 6), (4, 9, 2),
                                          (1, 64, 63), (6, 4, 0), (2, 4, 7)])
def test_masked_pairs_closed_form(sq, sk, offset):
    qpos = np.arange(sq)[:, None] + offset
    hidden = int((qpos < np.arange(sk)[None, :]).sum())
    call = dryrun.AttentionCall(1, 1, sq, sk, 8, True, offset, 2)
    assert call.masked_pairs() == hidden
    assert dataclasses.replace(call, causal=False).masked_pairs() == 0


@pytest.mark.parametrize("shape,remat,passes", [(PREFILL, True, 2), (TRAIN, True, 8),
                                                (TRAIN, False, 6)])
def test_masked_half_comes_off_in_closed_form(shape, remat, passes):
    """Every layer's causal square, S(S-1)/2 hidden pairs, 2 hd FLOPs a
    pair a pass: QKᵀ and PV forward, their four backward products, and
    remat's replay of the forward."""
    cfg = get_arch("internlm2-1.8b", reduced=True).replace(remat=remat)
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    rec = dryrun.lower_cell("internlm2-1.8b", shape, accum_override=1, config_overrides=over)
    s = shape.seq
    want = cfg.n_layers * 2 * cfg.hd * shape.batch * cfg.n_heads * (s * (s - 1) // 2) * passes
    assert rec["attention_masked_flops"] == want
    assert rec["flops_per_device"] == rec["flops_computed"] - want
    assert rec["attention_calls"] == cfg.n_layers * (2 if remat and shape.kind == "train" else 1)


def test_unmasked_encoder_keeps_every_flop():
    cfg = get_arch("whisper-tiny", reduced=True)
    with shapes.fake_mode():
        model = shapes.fake_model(cfg)
        frames = shapes.sds((2, cfg.encoder_seq, cfg.d_model), cfg.dtype)
        _, counter = dryrun.count(model.encoder, frames)
    assert counter.attention and not any(c.causal for c in counter.attention)
    rec = counter.record()
    assert rec["flops_computed"] > 0 and rec["flops_needed"] == rec["flops_computed"]


def test_decode_counts_its_cache_writes():
    """A dense decode step writes one position of every layer's k and v."""
    cfg = get_arch("internlm2-1.8b", reduced=True)
    spec = ShapeSpec("decode_s48", "decode", 48, 2)
    rec = dryrun.lower_cell("internlm2-1.8b", spec, config_overrides=_reduced("internlm2-1.8b"))
    item = torch.tensor([], dtype=cfg.dtype).element_size()
    one_position = spec.batch * cfg.n_kv_heads * cfg.hd * item
    assert rec["cache_write_bytes"] == cfg.n_layers * 2 * one_position  # k and v
    assert rec["attention_masked_flops"] == 0  # the query at S - 1 sees every key


def test_counter_matches_flop_counter_mode():
    cfg = get_arch("whisper-tiny", reduced=True)
    with shapes.fake_mode():
        model = shapes.fake_model(cfg)
        tokens, cache, pos = shapes.decode_specs(cfg, model, ShapeSpec("d", "decode", 24, 2))
        _, counter = dryrun.count(model.decode_step, tokens, cache, pos)
        with FlopCounterMode(display=False) as fcm:
            model.decode_step(tokens, cache, pos)
    assert counter.flops == fcm.get_total_flops() > 0


# ---------------------------------------------------------------------------
# loops counted by their trip count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_slstm_trip_count_equals_stepped(kind):
    cfg = get_arch("xlstm-350m", reduced=True)
    shape = ShapeSpec(f"{kind}_s16", kind, 16, 2)

    def counted(trip_count):
        with shapes.fake_mode():
            model = shapes.fake_model(cfg)
            batch = shapes.batch_specs(cfg, shape)
            if kind == "prefill":
                return dryrun.count(model.prefill, batch["tokens"], trip_count=trip_count)[1]
            from repro_torch.training import train_step as tts
            opt = tts.make_optimizer("adamw", 1e-4)
            step = tts.make_train_step(model, opt)
            return dryrun.count(step, tts.init_opt_state(model, opt), batch,
                                trip_count=trip_count)[1]

    trips, stepped = counted(True), counted(False)
    assert trips.flops == stepped.flops > 0
    # a train step's forward runs every pair twice: once, and remat's replay
    calls = cfg.n_layers // 2 * (2 if kind == "train" and cfg.remat else 1)
    assert trips.loops["models/ssm.py SLstm.scan"] == {"trips": 16 * calls, "calls": calls}
    assert not stepped.loops
    if kind == "prefill":  # the same ops, so the same bytes
        assert (trips.op_bytes, trips.ops) == (stepped.op_bytes, stepped.ops)


def test_microbatches_trip_count_equals_stepped():
    """Accumulation counted as the first microbatch ``accum`` times equals
    every microbatch stepped: the same ops, FLOPs and bytes."""
    cfg = get_arch("qwen2-moe-a2.7b", reduced=True)
    shape = ShapeSpec("train_s32", "train", 32, 4)

    def counted(trip_count):
        with shapes.fake_mode():
            model = shapes.fake_model(cfg)
            from repro_torch.training import train_step as tts
            opt = tts.make_optimizer("adamw", 1e-4)
            step = tts.make_train_step(model, opt, tts.TrainStepConfig(accum_steps=ACCUM))
            return dryrun.count(step, tts.init_opt_state(model, opt),
                                shapes.batch_specs(cfg, shape), trip_count=trip_count)[1]

    trips, stepped = counted(True), counted(False)
    assert (trips.flops, trips.op_bytes, trips.ops) == (stepped.flops, stepped.op_bytes,
                                                         stepped.ops)
    assert trips.loops == {"training/train_step.py microbatches": {"trips": ACCUM, "calls": 1}}
    assert trips.masked_flops() == stepped.masked_flops() > 0


# ---------------------------------------------------------------------------
# the RL cell
# ---------------------------------------------------------------------------

def test_spars_rl_cell_on_the_cpu():
    rec = dryrun.lower_spars_rl(n_envs=8, device="cpu")
    assert rec["status"] == "ok" and rec["shape"] == "a2c_envs8"
    assert rec["flops_per_device"] > 0 and rec["op_bytes"] > 0
    assert all(np.isfinite(v) for v in rec["metrics"].values())
    assert rec["peak"]["flops_per_s"] == mesh.PEAK_FLOPS_F32


def test_spars_rl_needs_a_device_it_can_reach():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.lower_spars_rl(n_envs=8)


# ---------------------------------------------------------------------------
# builders, peaks and the roofline
# ---------------------------------------------------------------------------

def test_builders_refuse_real_tensors():
    cfg = get_arch("whisper-tiny")
    for build in (lambda: shapes.sds((2, 2), torch.float32),
                  lambda: shapes.batch_specs(cfg, shapes.SHAPE_SETS["decode_32k"]),
                  lambda: shapes.fake_model(cfg)):
        with pytest.raises(RuntimeError, match="fake_mode"):
            build()


def test_active_params_count_shared_experts_in_full():
    cfg = get_arch("qwen2-moe-a2.7b", reduced=True)
    n = shapes.param_count(cfg)
    routed = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.expert_d_ff
    assert dryrun._active_params(cfg, n) == n - routed + routed * cfg.top_k / cfg.n_experts
    dense = get_arch("internlm2-1.8b", reduced=True)
    assert dryrun._active_params(dense, 123) == 123.0


@pytest.mark.parametrize("args", [(1e12, 1e9, 0.0), (1e9, 1e12, 0.0), (0.0, 0.0, 0.0),
                                  (5e14, 2e12, 1e9)])
def test_roofline_terms_are_the_references(args):
    peaks = (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW)
    assert dryrun.roofline_terms(*args, *peaks) == jroofline_terms(*args, *peaks)


def test_peaks_and_card():
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_TF32, mesh.PEAK_FLOPS_F32) == (989e12, 495e12,
                                                                                 67e12)
    assert (mesh.HBM_BW, mesh.HBM_BYTES, mesh.NVLINK_BW) == (3.35e12, 80e9, 900e9)
    line = mesh.card()
    assert line is None or "," in line


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_main_writes_a_record_a_cell(tmp_path, capsys):
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k,long_500k",
                 "--out", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "[ok     ] whisper-tiny__decode_32k count=" in printed
    assert "[skipped] whisper-tiny__long_500k" in printed
    assert "DRY-RUN SUMMARY: 1 ok, 1 skipped(documented), 0 errors" in printed
    rec = json.loads((tmp_path / "whisper-tiny__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["roofline"]["roofline_step_s"] > 0


def test_main_exits_1_on_an_error(tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert exit_.value.code == 1
    assert "[error  ] no-such-arch__decode_32k" in capsys.readouterr().out
    assert "KeyError" in (tmp_path / "no-such-arch__decode_32k.json").read_text()


# ---------------------------------------------------------------------------
# against the reference (its subprocess has run beside the cases above)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flops_computed_hold_to_the_reference_hlo(reference, arch, kind):
    if kind == "prefill":
        rec = dryrun.lower_cell(arch, PREFILL, config_overrides=_reduced(arch))
    else:
        rec = dryrun.lower_cell(arch, TRAIN, accum_override=ACCUM,
                                config_overrides=_reduced(arch))
        assert rec["accum_steps"] == ACCUM
    want = reference["hlo"][f"{arch}/{kind}"]
    assert rec["status"] == "ok"
    assert abs(rec["flops_computed"] - want) <= HLO_REL * want, (rec["flops_computed"], want)


@pytest.mark.parametrize("arch", list_archs())
def test_builders_match_the_reference(reference, arch):
    n, ref_count, biggest = reference["params"][arch]
    cfg = get_arch(arch)
    assert shapes.param_count(cfg) == n
    # the reference's param_count sums int32 products: right only below 2**31
    assert (ref_count == n) == (biggest < 2**31), (ref_count, n)
    with shapes.fake_mode():
        for name, spec in shapes.SHAPE_SETS.items():
            got = {k: [list(v.shape), v.dtype] for k, v in shapes.batch_specs(cfg, spec).items()}
            want = reference["batch"][arch][name]
            assert set(got) == set(want)
            for k, (shape, dtype) in want.items():
                assert got[k][0] == shape
                assert str(got[k][1]).split(".")[1] == ("int64" if k == "tokens" else dtype)
    assert (shapes.train_accum_steps(cfg, n, shapes.SHAPE_SETS["train_4k"])
            == reference["accum"][arch])
