"""The PyTorch port's grouped-tables path against the JAX reference: the
``GroupTables`` lowering field by field, its carry through
``core/convert.py``, the occupancy ledger, and whole simulations — port
grouped == JAX grouped == sequential oracle per scheduler label, on the
3-group Curie and mixed platforms and under ``node_order="pack"``,
``allocation="partition"`` and ``merge_bursts``.

Schedule tables and every integer field of the final state are identical
(including ``occ``); energy agrees to rel 1e-5 with the JAX engine and the
f64 oracle (SEMANTICS §Numerics). The port's grouped run is also held
against its own dense run: schedule bit-exact, energy to rtol 1e-6 (the
[G, 5] contraction sums in another order than the per-node reduce).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import metrics as jmet
from repro.core import policy as jpol
from repro.core import tables as jtab
from repro.core.ref.pydes import run_pydes
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro.workloads.workload import workload_from_arrays as j_from_arrays
from repro_torch.core import convert
from repro_torch.core import engine as teng
from repro_torch.core import metrics as tmet
from repro_torch.core import policy as tpol
from repro_torch.core import tables as ttab
from repro_torch.core.ref.pydes import run_pydes as t_run_pydes
from repro_torch.core.types import EngineConfig as TConfig
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat
from repro_torch.workloads.workload import workload_from_arrays as t_from_arrays

LABELS = [
    f"{base} {psm}"
    for base in ("FCFS", "EASY")
    for psm in ("PSUS", "PSAS", "PSAS+IPM")
] + ["EASY AlwaysOn"]

# every schedule/accounting field of the state; energy is compared apart
SCHEDULE_FIELDS = (
    "t", "job_start", "job_finish", "job_status", "job_eff",
    "job_terminated", "node_state", "node_until", "n_batches", "n_allocs",
    "n_starts", "n_completions", "n_switch_on", "n_switch_off", "truncated",
)

PLATFORMS = {
    "curie": (lambda: jplat.curie_platform(30), lambda: tplat.curie_platform(30)),
    "mixed": (lambda: jplat.mixed_platform_example(12),
              lambda: tplat.mixed_platform_example(12)),
    "homogeneous": (lambda: jplat.PlatformSpec(nb_nodes=8),
                    lambda: tplat.PlatformSpec(nb_nodes=8)),
}


def _configs(label, **kw):
    jb, jp = jpol.from_label(label)
    tb, tp = tpol.from_label(label)
    return JConfig(base=jb, policy=jp, **kw), TConfig(base=tb, policy=tp, **kw)


def _workloads(**wl_cfg):
    return (
        jgen.generate_workload(jgen.GeneratorConfig(**wl_cfg)),
        tgen.generate_workload(tgen.GeneratorConfig(**wl_cfg)),
    )


def _as_np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _assert_same_run(s_t, s_other, rtol):
    for fld in SCHEDULE_FIELDS:
        np.testing.assert_array_equal(
            _as_np(getattr(s_t, fld)), _as_np(getattr(s_other, fld)),
            err_msg=fld,
        )
    np.testing.assert_allclose(
        _as_np(s_t.energy), _as_np(s_other.energy), rtol=rtol, atol=1e-3
    )


def _three_way(label, plat, wl_cfg, against_dense=True, **cfg_kw):
    """Port grouped, JAX grouped and the oracle on one configuration; the
    port's grouped run is also held against its dense run."""
    jp, tp = PLATFORMS[plat][0](), PLATFORMS[plat][1]()
    jw, tw = _workloads(**wl_cfg)
    jc, tc = _configs(label, grouped_tables=True, **cfg_kw)
    s_t = teng.simulate(tp, tw, tc, device="cpu")
    # the reference's traced-flag program (bit-identical to its specialized
    # one) compiles once for all labels of one shape
    s_j = jeng.simulate(jp, jw, jc, specialize=False)
    m_o, des = run_pydes(jp, jw, jc)
    tab = tmet.schedule_table(s_t)
    np.testing.assert_array_equal(tab, jmet.schedule_table(s_j))
    np.testing.assert_array_equal(tab, des.schedule_table())
    _assert_same_run(s_t, s_j, rtol=1e-5)
    np.testing.assert_array_equal(_as_np(s_t.occ), _as_np(s_j.occ))
    m_t = tmet.metrics_from_state(s_t, tp)
    m_j = jmet.metrics_from_state(s_j, jp)
    for m in (m_j, m_o):
        assert m_t.total_energy_j == pytest.approx(m.total_energy_j, rel=1e-5)
        assert m_t.wasted_energy_j == pytest.approx(m.wasted_energy_j, rel=1e-5)
        assert m_t.makespan_s == m.makespan_s
    if against_dense:
        dense = teng.simulate(
            tp, tw, dataclasses.replace(tc, grouped_tables=False), device="cpu"
        )
        _assert_same_run(s_t, dense, rtol=1e-6)


# --------------------------------------------------------------------------
# the lowering and its carry across engines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("node_order", ["id", "cheap", "idle-watts", "pack"])
@pytest.mark.parametrize("plat", sorted(PLATFORMS))
def test_group_tables_match_reference(plat, node_order):
    jp, tp = PLATFORMS[plat][0](), PLATFORMS[plat][1]()
    want = jtab.group_tables(jp, JConfig(node_order=node_order))
    got = ttab.group_tables(tp, TConfig(node_order=node_order), device="cpu")
    assert ttab.GroupTables._fields == jtab.GroupTables._fields
    for k in jtab.GroupTables._fields:
        w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_group_tables_reject_intra_group_variation():
    """A platform whose per-node tables vary within a group cannot be
    lowered: the port refuses it, as the reference does."""
    gid = np.asarray([0, 0, 1], np.int32)
    bad = np.asarray([[1.0], [2.0], [3.0]], np.float32)
    with pytest.raises(ValueError, match="varies within a node group"):
        ttab._uniform_rows("watts", bad, gid, 2)
    ok = np.asarray([[1.0], [1.0], [3.0]], np.float32)
    np.testing.assert_array_equal(
        ttab._uniform_rows("watts", ok, gid, 2),
        jtab._uniform_rows("watts", ok, gid, 2),
    )


def test_convert_carries_group_tables():
    """The reference's grouped ``EngineConst`` comes across with its tables,
    and a run from it equals the port's own grouped run."""
    jp, tp = jplat.curie_platform(30), tplat.curie_platform(30)
    jw, tw = _workloads(n_jobs=30, nb_res=30, seed=2)
    jc, tc = _configs("EASY PSAS", timeout=120, node_order="cheap",
                      grouped_tables=True)
    jconst = jeng.make_const(jp, jc, specialize=True)
    d = {k: v for k, v in jconst._asdict().items()}
    d["policy"] = tuple(jconst.policy)
    tconst = convert.const_from_arrays(d, device="cpu")
    own = teng.make_const(tp, tc, device="cpu")
    assert isinstance(tconst.tables, ttab.GroupTables)
    for k in ttab.GroupTables._fields:
        np.testing.assert_array_equal(
            getattr(tconst.tables, k).numpy(), getattr(own.tables, k).numpy(),
            err_msg=k,
        )
    s0 = teng.init_state(tp, tw, tc, device="cpu")
    tc = teng.trim_window(tc, len(tw))
    got = teng.run_sim(s0, tconst, tc)
    want = teng.run_sim(s0, own, tc)
    _assert_same_run(got, want, rtol=0.0)


def test_occ_invariant():
    """The [G, 5] ledger partitions the nodes: each group's row sums to its
    node count, at init and in the final state."""
    tp = tplat.mixed_platform_example(12)
    _, tw = _workloads(n_jobs=40, nb_res=12, seed=5)
    _, tc = _configs("EASY PSAS+IPM", timeout=100, node_order="cheap",
                     grouped_tables=True)
    count = teng.make_const(tp, tc, device="cpu").tables.count.numpy()
    s0 = teng.init_state(tp, tw, tc, device="cpu")
    s = teng.simulate(tp, tw, tc, device="cpu")
    for state in (s0, s):
        assert state.occ.dtype == teng.I32
        np.testing.assert_array_equal(state.occ.numpy().sum(axis=1), count)
    assert not np.array_equal(s.occ.numpy(), s0.occ.numpy())


def test_grouped_kernel_route_matches_plain_route():
    """``fused_kernel=True`` routes the grouped event pass through the
    ``event_fuse_occ`` wrapper (its plain version on the CPU): the same
    schedule, occupancy and energy, bit for bit, as the plain route."""
    tp = tplat.mixed_platform_example(12)
    _, tw = _workloads(n_jobs=40, nb_res=12, seed=2)
    _, tc = _configs("EASY PSUS", timeout=100, node_order="cheap",
                     grouped_tables=True)
    plain = teng.simulate(tp, tw, dataclasses.replace(tc, fused_kernel=False),
                          device="cpu")
    kern = teng.simulate(tp, tw, dataclasses.replace(tc, fused_kernel=True),
                         device="cpu")
    _assert_same_run(kern, plain, rtol=0.0)
    np.testing.assert_array_equal(kern.occ.numpy(), plain.occ.numpy())
    np.testing.assert_array_equal(kern.energy.numpy(), plain.energy.numpy())


# --------------------------------------------------------------------------
# whole runs: port == JAX == oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("plat", ["curie", "mixed"])
@pytest.mark.parametrize("label", LABELS)
def test_grouped_parity(label, plat):
    n = 30 if plat == "curie" else 12
    _three_way(
        label, plat, dict(n_jobs=40, nb_res=n, seed=11, overrun_prob=0.2),
        timeout=120, terminate_overrun=True, node_order="cheap",
    )


OPTIONS = {
    "pack": dict(node_order="pack"),
    "partition": dict(node_order="cheap", allocation="partition"),
    "merge_bursts": dict(node_order="cheap", merge_bursts=True, window=4),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("label", LABELS)
def test_grouped_option_parity(label, option):
    """pack, partition and merge_bursts on the grouped path, per label, on
    the 3-group mixed platform (jobs of at most 4 nodes: every group can
    hold any of them under partition). Grouped == dense under each option
    is checked for one label."""
    _three_way(
        label, "mixed",
        dict(n_jobs=60, nb_res=12, max_res=4, seed=1, overrun_prob=0.2),
        against_dense=label == "EASY PSAS+IPM",
        timeout=300, terminate_overrun=True, **OPTIONS[option],
    )


def _burst(from_arrays, n_jobs=100, runtime=30):
    res = np.ones(n_jobs, np.int64)
    subtime = np.zeros(n_jobs, np.int64)
    run = np.full(n_jobs, runtime, np.int64)
    return from_arrays(res, subtime, run, nb_res=n_jobs)


@pytest.mark.parametrize("grouped", [False, True])
def test_merge_bursts_drains_a_burst_in_one_batch(grouped):
    """A same-timestamp burst wider than the window starts entirely at t=0
    under merge_bursts, as in the JAX engine and both oracles; without it
    the tail waits."""
    jp, tp = jplat.PlatformSpec(nb_nodes=100), tplat.PlatformSpec(nb_nodes=100)
    jw, tw = _burst(j_from_arrays), _burst(t_from_arrays)
    jc, tc = _configs("EASY PSUS", timeout=300, window=32,
                      grouped_tables=grouped)
    jc, tc = (dataclasses.replace(c, merge_bursts=True) for c in (jc, tc))
    merged = teng.simulate(tp, tw, tc, device="cpu")
    plain = teng.simulate(
        tp, tw, dataclasses.replace(tc, merge_bursts=False), device="cpu"
    )
    np.testing.assert_array_equal(merged.job_start.numpy(), 0)
    assert int(plain.job_start.max()) > 0
    assert int(merged.n_batches) < int(plain.n_batches)
    s_j = jeng.simulate(jp, jw, jc)
    _assert_same_run(merged, s_j, rtol=1e-5)
    tab = tmet.schedule_table(merged)
    np.testing.assert_array_equal(tab, jmet.schedule_table(s_j))
    np.testing.assert_array_equal(tab, run_pydes(jp, jw, jc)[1].schedule_table())
    np.testing.assert_array_equal(tab, t_run_pydes(tp, tw, tc)[1].schedule_table())


@pytest.mark.parametrize("grouped", [False, True])
def test_partition_oversize_job_never_starts(grouped):
    """A job wider than every group never starts under partition (EASY
    backfills past it), on the port and the JAX engine alike."""
    jp, tp = jplat.mixed_platform_example(16), tplat.mixed_platform_example(16)
    arrs = dict(res=np.asarray([2, 3, 7, 1, 2, 4], np.int64),
                subtime=np.asarray([0, 10, 20, 30, 40, 50], np.int64),
                runtime=np.asarray([300, 200, 100, 50, 400, 80], np.int64))
    jw = j_from_arrays(arrs["res"], arrs["subtime"], arrs["runtime"], nb_res=16)
    tw = t_from_arrays(arrs["res"], arrs["subtime"], arrs["runtime"], nb_res=16)
    jc, tc = _configs("EASY PSUS", timeout=300, allocation="partition",
                      grouped_tables=grouped)
    s_t = teng.simulate(tp, tw, tc, device="cpu")
    tab = tmet.schedule_table(s_t)
    np.testing.assert_array_equal(tab, jmet.schedule_table(jeng.simulate(jp, jw, jc)))
    assert tab[2, 0] == -1  # the 7-node job: the largest group has 6
    assert (np.delete(tab[:, 0], 2) >= 0).all()
    any_tab = tmet.schedule_table(teng.simulate(
        tp, tw, dataclasses.replace(tc, allocation="any"), device="cpu"))
    assert any_tab[2, 0] >= 0


@pytest.mark.parametrize("grouped", [False, True])
def test_pack_prefers_idle_nodes_over_waking_sleepers(grouped):
    """The pack band: while idle unreserved capacity exists, packing never
    wakes a sleeping node — on the port, the JAX engine and both oracles."""
    jp, tp = jplat.PlatformSpec(nb_nodes=8), tplat.PlatformSpec(nb_nodes=8)
    arrs = (np.asarray([4, 1], np.int64), np.asarray([0, 200], np.int64),
            np.asarray([10, 10], np.int64))
    jw, tw = j_from_arrays(*arrs, nb_res=8), t_from_arrays(*arrs, nb_res=8)
    jc = JConfig(timeout=5, node_order="pack", grouped_tables=grouped)
    tc = TConfig(timeout=5, node_order="pack", grouped_tables=grouped)
    s = teng.simulate(tp, tw, tc, device="cpu")
    assert int(s.n_switch_on) == 0
    s_j = jeng.simulate(jp, jw, jc)
    _assert_same_run(s, s_j, rtol=1e-5)
    tab = tmet.schedule_table(s)
    np.testing.assert_array_equal(tab, jmet.schedule_table(s_j))
    np.testing.assert_array_equal(tab, run_pydes(jp, jw, jc)[1].schedule_table())
    np.testing.assert_array_equal(tab, t_run_pydes(tp, tw, tc)[1].schedule_table())
