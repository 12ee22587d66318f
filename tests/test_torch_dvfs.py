"""Rule 9 (DVFS) through the PyTorch port's ``simulate``, against the JAX
engine and the port's sequential oracle.

For every DVFS label (``scheduler_labels(include_dvfs=True)``'s and the
compositions ``PSUS+DVFS``, ``PSAS+IPM+DVFS``), on the reference's DVFS
platform (three groups with slow/base/turbo modes), the mixed platform (one
mode a group) and an 8-node homogeneous platform, dense and grouped: the
schedule table is identical to the JAX engine's and the oracle's; energy,
``mode_time`` and ``mode_energy`` agree to rel 1e-5; and ``utilization``
(the per-mode ledger division once DVFS ran) equals the reference's
``metrics_from_state`` to rel 1e-5. The grouped run takes the occupancy
route, whose ACTIVE column is priced at the mode watts.

One exception, a fault of the reference: on its dense route the JAX engine
scatter-adds every ACTIVE node's ``watts * dt`` straight into the
uncompensated f32 ``mode_energy`` cell, so its error grows with nodes and
batches (rel 1.7e-5 from the f64 oracle at 16 nodes and 100 jobs). The
port adds one group sum a batch (4.9e-7 from the oracle on the same run).
There the port's ``mode_energy`` is held to the oracle at rel 1e-5 and to
the JAX engine at rel 1e-4 (:data:`JAX_DENSE_MODE_ENERGY_RTOL`).
"""
import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import metrics as jmet
from repro.core import policy as jpol
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import engine as teng
from repro_torch.core import metrics as tmet
from repro_torch.core import policy as tpol
from repro_torch.core.ref.pydes import run_pydes
from repro_torch.core.types import EngineConfig as TConfig
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

DVFS_LABELS = tuple(
    lbl for lbl in tpol.scheduler_labels(include_dvfs=True) if "DVFS" in lbl
) + ("EASY PSUS+DVFS", "EASY PSAS+IPM+DVFS")

# the JAX engine's dense-route mode_energy against the port's (see above)
JAX_DENSE_MODE_ENERGY_RTOL = 1e-4

PLATFORMS = {
    "dvfs": (jplat.dvfs_platform_example, tplat.dvfs_platform_example),
    "mixed": (jplat.mixed_platform_example, tplat.mixed_platform_example),
    "homogeneous": (
        lambda n: jplat.PlatformSpec(nb_nodes=n, t_switch_on=120, t_switch_off=180),
        lambda n: tplat.PlatformSpec(nb_nodes=n, t_switch_on=120, t_switch_off=180),
    ),
}


def three_way(label, plat, n=8, wl_cfg=None, workload=None, **cfg_kw):
    """The port (CPU), the JAX engine (its traced-flag program, bit-identical
    to its specialized one and compiled once a shape) and the port's oracle
    on one configuration. Returns (port state, port metrics, JAX metrics,
    oracle metrics) after holding the three schedules equal and the port's
    energy, mode ledgers and utilization to the others' at rel 1e-5.

    ``plat`` names a :data:`PLATFORMS` entry or is a (JAX, port) platform
    pair; ``workload`` is a (JAX, port) workload pair, else one is generated
    from ``wl_cfg``."""
    jp, tp = (PLATFORMS[plat][0](n), PLATFORMS[plat][1](n)) if isinstance(plat, str) else plat
    if workload is None:
        cfg = {"n_jobs": 40, "nb_res": tp.nb_nodes, "seed": 3, "overrun_prob": 0.2,
               **(wl_cfg or {})}
        workload = (jgen.generate_workload(jgen.GeneratorConfig(**cfg)),
                    tgen.generate_workload(tgen.GeneratorConfig(**cfg)))
    jw, tw = workload
    jb, jpo = jpol.from_label(label)
    tb, tpo = tpol.from_label(label)
    jc = JConfig(base=jb, policy=jpo, **cfg_kw)
    tc = TConfig(base=tb, policy=tpo, **cfg_kw)
    s_t = teng.simulate(tp, tw, tc, device="cpu")
    s_j = jeng.simulate(jp, jw, jc, specialize=False)
    m_o, des = run_pydes(tp, tw, tc)
    tab = tmet.schedule_table(s_t)
    tag = f"{label} {cfg_kw}"
    np.testing.assert_array_equal(tab, jmet.schedule_table(s_j), err_msg=tag)
    np.testing.assert_array_equal(tab, des.schedule_table(), err_msg=tag)
    m_t = tmet.metrics_from_state(s_t, tp)
    m_j = jmet.metrics_from_state(s_j, jp)
    for m in (m_j, m_o):
        assert m_t.total_energy_j == pytest.approx(m.total_energy_j, rel=1e-5, abs=1e-3), tag
        assert m_t.wasted_energy_j == pytest.approx(m.wasted_energy_j, rel=1e-5, abs=1e-3), tag
        assert m_t.makespan_s == m.makespan_s, tag
        assert m_t.n_terminated == m.n_terminated, tag
        np.testing.assert_allclose(m_t.mode_residency_s, m.mode_residency_s,
                                   rtol=1e-5, atol=1e-3, err_msg=tag)
        dense_jax = m is m_j and not tc.grouped_tables
        np.testing.assert_allclose(
            m_t.energy_by_mode_j, m.energy_by_mode_j,
            rtol=JAX_DENSE_MODE_ENERGY_RTOL if dense_jax else 1e-5, atol=1e-3,
            err_msg=tag)
    np.testing.assert_allclose(m_t.energy_by_group_j, m_j.energy_by_group_j,
                               rtol=1e-5, atol=1e-3, err_msg=tag)
    assert m_t.utilization == pytest.approx(m_j.utilization, rel=1e-5), tag
    assert int(s_t.n_batches) == int(s_j.n_batches), tag
    return s_t, m_t, m_j, m_o


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("plat", sorted(PLATFORMS))
@pytest.mark.parametrize("label", DVFS_LABELS)
def test_dvfs_parity(label, plat, grouped):
    s, m, _, _ = three_way(label, plat, timeout=120, terminate_overrun=True,
                           node_order="cheap", grouped_tables=grouped)
    assert sum(map(sum, m.mode_residency_s)) > 0  # rule 9 ran
    if plat == "dvfs":  # the ladder left the base mode somewhere
        assert sum(row[0] + row[2] for row in m.mode_residency_s) > 0


def test_dvfs_changes_runtimes_and_utilization_reads_the_mode_ledger():
    """On the DVFS platform the mode table changes realized runtimes
    (against the same label without DVFS), and utilization is the per-mode
    division, not ACTIVE energy over the base watts."""
    s, m, m_j, _ = three_way("EASY DVFS", "dvfs", timeout=120, node_order="cheap")
    tp = tplat.dvfs_platform_example(8)
    tw = tgen.generate_workload(tgen.GeneratorConfig(
        n_jobs=40, nb_res=8, seed=3, overrun_prob=0.2))
    base = teng.simulate(tp, tw, TConfig(policy=tpol.AlwaysOn(), node_order="cheap"),
                         device="cpu")
    assert not np.array_equal(s.job_eff.numpy(), base.job_eff.numpy())
    by_base_watts = sum(
        e[3] / p for e, p in zip(m.energy_by_group_j, tp.group_active_powers())
    ) / (tp.nb_nodes * m.makespan_s)
    assert m.utilization != pytest.approx(by_base_watts, rel=1e-3)
    assert m.utilization == pytest.approx(m_j.utilization, rel=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("label", DVFS_LABELS + ("FCFS PSUS+DVFS", "EASY PSAS+DVFS"))
def test_dvfs_parity_wide(label, grouped, seed):
    three_way(label, "dvfs", n=16, wl_cfg={"n_jobs": 100, "seed": seed},
              timeout=300, terminate_overrun=True, node_order="cheap",
              grouped_tables=grouped)
