"""The slice as a whole: the PyTorch port's ``simulate`` on the CPU against
the JAX reference's ``engine.simulate`` and against the sequential oracle
``run_pydes``, for the paper's schedulers.

Schedule tables must be identical; total and wasted energy agree to rel
1e-5 (f32 Kahan ledgers against each other and against the f64 oracle,
SEMANTICS §Numerics); makespan and terminated counts are equal.
"""
import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import metrics as jmet
from repro.core import policy as jpol
from repro.core.ref.pydes import run_pydes
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import engine as teng
from repro_torch.core import metrics as tmet
from repro_torch.core import policy as tpol
from repro_torch.core.types import EngineConfig as TConfig
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

LABELS = [
    f"{base} {psm}"
    for base in ("FCFS", "EASY")
    for psm in ("PSUS", "PSAS", "PSAS+IPM")
] + ["EASY AlwaysOn"]


def _run_three(label, plat_j, plat_t, wl_cfg, **cfg_kw):
    jb, jp = jpol.from_label(label)
    tb, tp = tpol.from_label(label)
    jc = JConfig(base=jb, policy=jp, **cfg_kw)
    tc = TConfig(base=tb, policy=tp, **cfg_kw)
    jw = jgen.generate_workload(jgen.GeneratorConfig(**wl_cfg))
    tw = tgen.generate_workload(tgen.GeneratorConfig(**wl_cfg))
    s_t = teng.simulate(plat_t, tw, tc, device="cpu")
    s_j = jeng.simulate(plat_j, jw, jc)
    m_o, des = run_pydes(plat_j, jw, jc)
    return (
        (tmet.schedule_table(s_t), tmet.metrics_from_state(s_t, plat_t)),
        (jmet.schedule_table(s_j), jmet.metrics_from_state(s_j, plat_j)),
        (des.schedule_table(), m_o),
    )


def _assert_agree(port, others):
    tab_t, m_t = port
    for tab, m in others:
        np.testing.assert_array_equal(tab_t, tab)
        assert m_t.total_energy_j == pytest.approx(m.total_energy_j, rel=1e-5)
        assert m_t.wasted_energy_j == pytest.approx(m.wasted_energy_j, rel=1e-5)
        assert m_t.makespan_s == m.makespan_s
        assert m_t.n_terminated == m.n_terminated
        assert m_t.truncated == m.truncated


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("label", LABELS)
def test_homogeneous_parity(label, seed):
    port, ref, oracle = _run_three(
        label,
        jplat.PlatformSpec(nb_nodes=16), tplat.PlatformSpec(nb_nodes=16),
        dict(n_jobs=100, nb_res=16, seed=seed, overrun_prob=0.2),
        timeout=300, terminate_overrun=True,
    )
    _assert_agree(port, [ref, oracle])


@pytest.mark.parametrize("label", LABELS)
def test_mixed_platform_parity(label):
    """The 3-group mixed platform, cheap-first allocation: per-node tables,
    per-group ledgers and the f32 realized-runtime contract."""
    port, ref, oracle = _run_three(
        label,
        jplat.mixed_platform_example(16), tplat.mixed_platform_example(16),
        dict(n_jobs=100, nb_res=16, seed=3, overrun_prob=0.2),
        timeout=300, terminate_overrun=True, node_order="cheap",
    )
    _assert_agree(port, [ref, oracle])
    m_t, m_j = port[1], ref[1]
    assert len(m_t.energy_by_group_j) == 3
    for g_t, g_j in zip(m_t.energy_by_group_j, m_j.energy_by_group_j):
        np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=1.0)


@pytest.mark.parametrize("label", ["FCFS PSAS+IPM", "EASY PSUS"])
def test_truncated_flag_agrees_under_a_small_batch_cap(label):
    """A capped run is flagged by all three engines. The partial state is
    held against the reference engine only: the oracle counts its batches
    from the first loop step, so it stops one batch later."""
    with pytest.warns(RuntimeWarning, match="PARTIAL"):
        port, ref, oracle = _run_three(
            label,
            jplat.PlatformSpec(nb_nodes=16), tplat.PlatformSpec(nb_nodes=16),
            dict(n_jobs=100, nb_res=16, seed=0, overrun_prob=0.2),
            timeout=300, terminate_overrun=True, max_batches=25,
        )
    assert port[1].truncated and ref[1].truncated and oracle[1].truncated
    _assert_agree(port, [ref])
