"""The PyTorch port's engine modules against the JAX reference, field by
field: the copied workload/platform/policy layers, ``make_const`` and
``init_state``, one event batch continued from a mid-run JAX state through
``core/convert.py``, the configurations the port still refuses, the device rule,
and the package's isolation from ``jax`` and ``repro``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import policy as jpol
from repro.core.metrics import np_state as j_np_state
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import convert
from repro_torch.core import engine as teng
from repro_torch.core import policy as tpol
from repro_torch.core.types import EngineConfig as TConfig
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALL_LABELS = jpol.scheduler_labels(
    include_rl=True, include_dvfs=True, include_forecast=True
) + ("EASY PSAS+IPM+DVFS", "FCFS PSUS+Forecast+DVFS")


def _configs(label, **kw):
    jb, jp = jpol.from_label(label)
    tb, tp = tpol.from_label(label)
    return JConfig(base=jb, policy=jp, **kw), TConfig(base=tb, policy=tp, **kw)


def _platforms(n=16):
    return {
        "homogeneous": (jplat.PlatformSpec(nb_nodes=n), tplat.PlatformSpec(nb_nodes=n)),
        "mixed": (jplat.mixed_platform_example(n), tplat.mixed_platform_example(n)),
    }


def _assert_fields_equal(want: dict, got: dict, rtol=None):
    assert set(want) == set(got)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if rtol is not None and w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# --------------------------------------------------------------------------
# copied layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("label", ALL_LABELS)
def test_policy_registry_matches_reference(label):
    jb, jp = jpol.from_label(label)
    tb, tp = tpol.from_label(label)
    assert int(tb) == int(jb)
    assert type(tp).__name__ == type(jp).__name__
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tuple(tp.params(tb)) == tuple(jp.params(jb).static())
    assert tpol.label_of(tb, tp) == jpol.label_of(jb, jp)


@pytest.mark.parametrize("name", sorted(jgen.PRESETS))
def test_generator_gives_identical_jobs(name):
    jw = jgen.generate_workload(jgen.PRESETS[name])
    tw = tgen.generate_workload(tgen.PRESETS[name])
    assert jgen.PRESETS[name] == jgen.GeneratorConfig(
        **dataclasses.asdict(tgen.PRESETS[name])
    )
    ja, ta = jw.arrays(), tw.arrays()
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)


@pytest.mark.parametrize(
    "make", ["curie", "mixed", "homogeneous"],
)
def test_platform_tables_match_reference(make):
    if make == "curie":
        jp, tp = jplat.curie_platform(300), tplat.curie_platform(300)
    else:
        jp, tp = _platforms(24)[make]
    for fn in ("node_power_table", "node_t_switch_on", "node_t_switch_off",
               "node_speed", "node_order_key", "node_group_id"):
        np.testing.assert_array_equal(getattr(tp, fn)(), getattr(jp, fn)())
    for a, b in zip(tp.group_dvfs_tables(), jp.group_dvfs_tables()):
        np.testing.assert_array_equal(a, b)
    assert tp.group_names() == jp.group_names()


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

@pytest.mark.parametrize("plat", ["homogeneous", "mixed"])
@pytest.mark.parametrize("node_order", ["id", "cheap", "idle-watts"])
def test_make_const_and_init_state_match_reference(plat, node_order):
    jp, tp = _platforms()[plat]
    wl_cfg = dict(n_jobs=40, nb_res=16, seed=2)
    jw = jgen.generate_workload(jgen.GeneratorConfig(**wl_cfg))
    tw = tgen.generate_workload(tgen.GeneratorConfig(**wl_cfg))
    jc, tc = _configs("EASY PSAS+IPM", timeout=300, node_order=node_order)

    jconst = jeng.make_const(jp, jc, specialize=True)
    tconst = teng.make_const(tp, tc, device="cpu")
    assert tuple(tconst.policy) == tuple(jconst.policy)
    assert tconst.tables is None and jconst.tables is None
    fields = [k for k in jeng.EngineConst._fields if k not in ("policy", "tables")]
    assert [k for k in teng.EngineConst._fields] == list(jeng.EngineConst._fields)
    _assert_fields_equal(
        {k: np.asarray(getattr(jconst, k)) for k in fields},
        {k: getattr(tconst, k).numpy() for k in fields},
    )

    js = jeng.init_state(jp, jw, jc, job_capacity=48)
    ts = teng.init_state(tp, tw, tc, device="cpu", job_capacity=48)
    assert list(teng.SimState._fields) == list(jeng.SimState._fields)
    _assert_fields_equal(j_np_state(js), convert.state_to_arrays(ts))


# --------------------------------------------------------------------------
# one batch from a mid-run reference state
# --------------------------------------------------------------------------

def _mid_run_state(jp, jw, jc, jconst, process, advance):
    """The first reference state, stepping batch by batch with the body of
    the reference's fused loop, that has waiting, allocated and switching
    nodes/jobs at once."""
    s = process(jeng.init_state(jp, jw, jc))
    for _ in range(200):
        d = j_np_state(s)
        waiting = ((d["job_status"] == 0) & (d["job_subtime"] <= d["t"])).any()
        allocated = (d["job_status"] == 1).any()
        switching = np.isin(d["node_state"], (1, 4)).any()
        if waiting and allocated and switching:
            return d
        s = process(advance(s)[0])
    raise AssertionError("no mid-run state with waiting/allocated/switching")


@pytest.mark.parametrize("label", ["EASY PSAS+IPM", "FCFS PSUS"])
def test_one_batch_from_reference_state(label):
    jp = jplat.PlatformSpec(nb_nodes=16)
    wl_cfg = dict(n_jobs=60, nb_res=16, seed=4, overrun_prob=0.2)
    jw = jgen.generate_workload(jgen.GeneratorConfig(**wl_cfg))
    # fused_kernel=True: the reference's event pass runs its Pallas kernel
    # (interpret mode on the CPU); the port's takes the wrapper's plain route
    jc, tc = _configs(
        label, timeout=120, terminate_overrun=True, fused_kernel=True
    )
    jc, tc = jeng.trim_window(jc, len(jw)), teng.trim_window(tc, len(jw))
    jconst = jeng.make_const(jp, jc, specialize=True)

    @jax.jit
    def advance(s):  # the fused loop's event pass + accrual + clock step
        nt, aux = jeng.event_horizon(s, jconst, jc)
        return jeng.accrue_energy(s, nt, jconst, aux=aux)._replace(t=nt), aux

    process = jax.jit(lambda s: jeng.process_batch(s, jconst, jc))
    d = _mid_run_state(jp, jw, jc, jconst, process, advance)
    jd = {k: np.asarray(v) for k, v in jconst._asdict().items()
          if k != "tables"}
    jd["policy"] = tuple(jconst.policy)
    tconst = convert.const_from_arrays(jd, device="cpu")
    ts = convert.state_from_arrays(d, device="cpu")
    _assert_fields_equal(d, convert.state_to_arrays(ts))

    js, aux_j = advance(jeng.SimState(**d))
    nt_t, aux_t = teng.event_horizon(ts, tconst, tc)
    assert int(nt_t) == int(js.t) and bool(aux_t.quiet) == bool(aux_j.quiet)
    ts = teng.accrue_energy(ts, nt_t, tconst, aux=aux_t)._replace(t=nt_t)
    js = process(js)
    ts = teng.process_batch(ts, tconst, tc)
    # integer and bool fields exactly, the f32 ledger to rounding
    _assert_fields_equal(j_np_state(js), convert.state_to_arrays(ts), rtol=1e-6)


def test_convert_rejects_incomplete_or_mistyped_arrays():
    tp = tplat.PlatformSpec(nb_nodes=4)
    tw = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=5, nb_res=4))
    d = convert.state_to_arrays(
        teng.init_state(tp, tw, TConfig(), device="cpu")
    )
    with pytest.raises(KeyError, match="node_state"):
        convert.state_from_arrays(
            {k: v for k, v in d.items() if k != "node_state"}, device="cpu"
        )
    with pytest.raises(TypeError, match="job_res"):
        convert.state_from_arrays(
            {**d, "job_res": d["job_res"].astype(np.int64)}, device="cpu"
        )


# --------------------------------------------------------------------------
# what this slice refuses, and the device rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize(
    "label,kw",
    [
        ("EASY RL:groups", {"grouped_tables": True}),
        ("EASY PSUS+DVFS", {"grouped_tables": True}),
        ("FCFS PSAS+IPM+Forecast", {"node_order": "pack"}),
        ("EASY PSUS", {"devices": 1}),
        ("EASY PSUS", {"devices": 2}),
        ("EASY PSUS", {"fused_events": False}),
        ("EASY RL", {}),
        ("EASY DVFS", {}),
        ("EASY PSUS+Forecast", {}),
    ],
)
def test_unported_configs_raise(label, kw):
    tp = tplat.PlatformSpec(nb_nodes=8)
    tw = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=5, nb_res=8))
    _, tc = _configs(label, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        teng.simulate(tp, tw, tc, device="cpu")


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for its absence")
    from repro_torch.launch.sim import run

    tp = tplat.PlatformSpec(nb_nodes=8)
    tw = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=5, nb_res=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.simulate(tp, tw, TConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run({"workload": "preset:fig3_small", "out": "unused"})
    s = teng.simulate(tp, tw, TConfig(), device="cpu")
    assert s.t.device.type == "cpu"


def test_package_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.engine, repro_torch.launch.sim\n"
        "import repro_torch.core.convert, repro_torch.core.metrics\n"
        "import repro_torch.core.ref.pydes, repro_torch.kernels.event_fuse\n"
        "import repro_torch.core.tables, repro_torch.workloads.traces\n"
        "import repro_torch.experiments\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""
