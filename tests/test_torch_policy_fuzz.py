"""Differential fuzz over the policy stack with the PyTorch port as a third
engine: port == JAX engine == sequential oracle on every case.

The corpus is ``tests/test_policy_fuzz.py``'s: its seeded case drawer, its
three platforms (homogeneous, 3-group mixed, 3-group with DVFS mode
tables) and its labels (every registry label plus four deeper
``+DVFS``/``+Forecast`` compositions), with random timeouts, horizons,
alphas, node orders, grouped tables, burst merging and overrun handling.
Each case holds the port's schedule bit for bit against the JAX engine's
and the port's oracle, its energy to rel 1e-5 of both, its per-group and
per-state ledgers to its total, and its mode ledgers to the oracle's.

The default lane runs a few cases of that corpus (the first of its seeds);
``slow`` runs more. ``SPARS_TORCH_FUZZ_CASES`` scales the slow lane.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import metrics as jmet
from repro_torch.core import engine as teng
from repro_torch.core import metrics as tmet
from repro_torch.core import policy as tpol
from repro_torch.core.ref.pydes import run_pydes
from repro_torch.core.types import EngineConfig as TConfig
from repro_torch.workloads import platform as tplat
from repro_torch.workloads.workload import workload_from_arrays
from test_policy_fuzz import LABELS, PLATS, _draw_case

N_DEFAULT = 6
N_SLOW = int(os.environ.get("SPARS_TORCH_FUZZ_CASES", "40"))

# the port's twins of test_policy_fuzz.PLATS, in its order
T_PLATS = (
    tplat.PlatformSpec(nb_nodes=8, t_switch_on=120, t_switch_off=180),
    tplat.mixed_platform_example(8),
    tplat.dvfs_platform_example(8),
)


def _port_case(plat, wl, cfg):
    """The port's (platform, workload, config) for a drawn JAX case."""
    tp = T_PLATS[PLATS.index(plat)]
    assert tp.to_json() == plat.to_json()
    a = wl.arrays()
    tw = workload_from_arrays(a["res"].tolist(), a["subtime"].tolist(),
                              a["runtime"].tolist(), a["reqtime"].tolist(),
                              nb_res=wl.nb_res)
    base, pol = tpol.from_label(cfg.label())
    assert dataclasses.asdict(pol) == dataclasses.asdict(cfg.policy)
    rest = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("base", "psm", "policy")}
    return tp, tw, TConfig(base=base, policy=pol, **rest)


def _check_case(seed):
    plat, wl, cfg = _draw_case(np.random.default_rng(seed))
    tp, tw, tc = _port_case(plat, wl, cfg)
    tag = (f"seed={seed} {tc.label()} timeout={tc.timeout} h={tc.forecast_horizon} "
           f"a={tc.forecast_alpha} order={tc.node_order} grouped={tc.grouped_tables} "
           f"merge={tc.merge_bursts} overrun={tc.terminate_overrun} "
           f"plat={tp.nb_nodes}n/{tp.n_groups()}g")
    s_t = teng.simulate(tp, tw, tc, device="cpu")
    s_j = jeng.simulate(plat, wl, cfg, specialize=False)
    m_o, des = run_pydes(tp, tw, tc)
    tab = tmet.schedule_table(s_t)
    np.testing.assert_array_equal(tab, jmet.schedule_table(s_j),
                                  err_msg=f"port/JAX divergence: {tag}")
    np.testing.assert_array_equal(tab, des.schedule_table(),
                                  err_msg=f"port/oracle divergence: {tag}")
    m = tmet.metrics_from_state(s_t, tp)
    m_j = jmet.metrics_from_state(s_j, plat)
    for ref in (m_j, m_o):
        assert m.makespan_s == ref.makespan_s, tag
        assert m.n_terminated == ref.n_terminated, tag
        assert m.total_energy_j == pytest.approx(ref.total_energy_j, rel=1e-5, abs=1e-3), tag
    assert m.total_energy_j == pytest.approx(
        sum(sum(g) for g in m.energy_by_group_j), rel=1e-5, abs=1e-3), tag
    assert m.total_energy_j == pytest.approx(sum(m.energy_by_state_j), rel=1e-5, abs=1e-3), tag
    assert 0.0 <= m.wasted_energy_j <= m.total_energy_j + 1e-6, tag
    np.testing.assert_allclose(m.mode_residency_s, m_o.mode_residency_s,
                               rtol=1e-5, atol=1e-3, err_msg=tag)
    np.testing.assert_allclose(m.energy_by_mode_j, m_o.energy_by_mode_j,
                               rtol=1e-5, atol=1e-3, err_msg=tag)
    assert int(s_t.n_batches) == int(s_j.n_batches), tag


def test_corpus_labels_are_the_reference_fuzz_labels():
    assert len(LABELS) == len(tpol.scheduler_labels(
        include_dvfs=True, include_forecast=True)) + 4


# the reference fuzz's seed base, so these are its first cases
@pytest.mark.parametrize("case", range(N_DEFAULT))
def test_three_engine_differential_fuzz(case):
    _check_case(77_000 + case)


@pytest.mark.slow
@pytest.mark.parametrize("case", range(N_DEFAULT, N_DEFAULT + N_SLOW))
def test_three_engine_differential_fuzz_wide(case):
    _check_case(77_000 + case)
