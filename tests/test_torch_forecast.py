"""Rule 10 (Forecast) through the PyTorch port's ``simulate``, against the
JAX engine and the port's sequential oracle, and its zero-knowledge
identities.

Live predictors (horizon 900 s, alpha 0.5): every Forecast label of
``scheduler_labels(include_forecast=True)`` and the compositions
``PSAS+IPM+Forecast`` and ``DVFS+Forecast`` (the DVFS pre-ramp), on the
DVFS, mixed and homogeneous 8-node platforms, dense and grouped — schedule
identical to the JAX engine's and the oracle's, energy and mode ledgers to
rel 1e-5 (``test_torch_dvfs.three_way``).

Zero knowledge (the reference's ``tests/test_forecast.py``): ``horizon=0``
and ``alpha=0`` make rule 10 a no-op, so a Forecast stack's schedule and f32
energy ledger equal its reactive base's bit for bit, and the zero horizon
adds no batch.
"""
import dataclasses

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
from repro_torch.core.types import EngineConfig as TConfig
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat
from test_torch_dvfs import PLATFORMS, three_way

FC_LABELS = tuple(
    lbl for lbl in tpol.scheduler_labels(include_forecast=True) if "Forecast" in lbl
) + ("EASY PSAS+IPM+Forecast", "EASY DVFS+Forecast")

# the reference's identity cases (tests/test_forecast.py)
ZK_LABELS = ("EASY PSUS+Forecast", "FCFS PSUS+Forecast", "EASY PSAS+IPM+Forecast",
             "EASY Forecast")
ZK_CASES = {
    "h=0": dict(forecast_horizon=0),
    "h=None": dict(forecast_horizon=None),
    "alpha=0": dict(forecast_horizon=900, forecast_alpha=0.0),
}


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("plat", sorted(PLATFORMS))
@pytest.mark.parametrize("label", FC_LABELS)
def test_forecast_parity(label, plat, grouped):
    three_way(label, plat, timeout=120, terminate_overrun=True, node_order="cheap",
              grouped_tables=grouped, forecast_horizon=900, forecast_alpha=0.5)


def _wl16(seed=11):
    cfg = tgen.GeneratorConfig(n_jobs=60, nb_res=16, seed=seed, overrun_prob=0.2)
    return tgen.generate_workload(cfg)


def _plat16():
    return tplat.PlatformSpec(nb_nodes=16, t_switch_on=120, t_switch_off=180)


def _reactive_base(label):
    base = label.replace("+Forecast", "")
    return base.replace(" Forecast", " AlwaysOn")


@pytest.mark.parametrize("case", sorted(ZK_CASES))
@pytest.mark.parametrize("label", ZK_LABELS)
def test_zero_knowledge_forecast_is_bit_exact_with_reactive_base(label, case):
    """The port's Forecast run equals its reactive base bit for bit:
    schedule, f32 energy ledger and switch counts, and under a zero horizon
    the batches too (no review tick; at alpha 0 the ticks still come, and
    change nothing); and the base's schedule is the JAX engine's."""
    tp, tw = _plat16(), _wl16()
    shared = dict(timeout=240, terminate_overrun=True)
    gb, gp = tpol.from_label(_reactive_base(label))
    golden = teng.simulate(tp, tw, TConfig(base=gb, policy=gp, **shared), device="cpu")
    fb, fp = tpol.from_label(label)
    s = teng.simulate(tp, tw, TConfig(base=fb, policy=fp, **shared, **ZK_CASES[case]),
                      device="cpu")
    np.testing.assert_array_equal(tmet.schedule_table(s), tmet.schedule_table(golden))
    for fld in ("energy", "n_switch_on", "n_switch_off", "t"):
        np.testing.assert_array_equal(getattr(s, fld).numpy(),
                                      getattr(golden, fld).numpy(), err_msg=fld)
    if case == "alpha=0":
        assert int(s.n_batches) > int(golden.n_batches)
    else:
        assert int(s.n_batches) == int(golden.n_batches)
    jb, jp = jpol.from_label(_reactive_base(label))
    jw = jgen.generate_workload(jgen.GeneratorConfig(
        n_jobs=60, nb_res=16, seed=11, overrun_prob=0.2))
    jgold = jeng.simulate(jplat.PlatformSpec(nb_nodes=16, t_switch_on=120, t_switch_off=180),
                          jw, JConfig(base=jb, policy=jp, **shared), specialize=False)
    np.testing.assert_array_equal(tmet.schedule_table(golden), jmet.schedule_table(jgold))


def test_forecast_wakes_nodes_and_adds_review_batches():
    """A live predictor does something: more switch-ons than the reactive
    base, a different schedule, and the review tick's extra batches; the
    predictor state leaves its initial values."""
    tp, tw = _plat16(), _wl16()
    gb, gp = tpol.from_label("EASY PSUS")
    golden = teng.simulate(tp, tw, TConfig(base=gb, policy=gp, timeout=120), device="cpu")
    fb, fp = tpol.from_label("EASY PSUS+Forecast")
    cfg = TConfig(base=fb, policy=fp, timeout=120, forecast_horizon=600)
    s = teng.simulate(tp, tw, cfg, device="cpu")
    assert int(s.n_switch_on) > int(golden.n_switch_on)
    assert int(s.n_batches) > int(golden.n_batches)
    assert not np.array_equal(tmet.schedule_table(s), tmet.schedule_table(golden))
    assert float(s.fc_gap) < 2.0**30 and float(s.fc_res) > 0.0
    frozen = teng.simulate(tp, tw, dataclasses.replace(cfg, forecast_alpha=0.0),
                           device="cpu")
    assert float(frozen.fc_gap) == 2.0**30 and float(frozen.fc_res) == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("horizon", [300, 1800])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("label", FC_LABELS + ("FCFS PSUS+DVFS+Forecast",))
def test_forecast_parity_wide(label, grouped, horizon):
    three_way(label, "dvfs", n=16, wl_cfg={"n_jobs": 100, "seed": 5},
              timeout=240, terminate_overrun=True, node_order="cheap",
              grouped_tables=grouped, forecast_horizon=horizon)
