"""Device-sharded sweeps on the PyTorch port (``repro_torch.core.shard``,
``sweep(devices=D)``) on the CPU, where D worker processes stand in for
the reference's forced host devices.

- ``sweep(devices=D)`` for D = 1, 2 and 3 on K = 5 scenarios (ragged
  splits: 3 + 2 and 2 + 2 + 1 rows), and on fewer rows than workers (an
  empty block runs nothing): every state field and every row bit for bit
  the port's unsharded sweep; the schedule tables equal the JAX
  ``engine.sweep``'s unsharded rows and the reference's oracle, energy to
  rel 1e-5;
- the cache key keeps (K, D) apart, ``"all"`` is 1 on the CPU, D < 1 and
  (on a card) D above the visible cards raise the reference's ValueError;
- the handle is asynchronous, the workers' host reads reach the parent's
  counter, a worker's exception and a worker's death raise in the parent,
  and what cannot cross (a CUDA tensor, a lambda controller) is refused;
- the runner (blocking and streamed) and the service at D = 2 and 3 write
  the unsharded run's bytes; the checkpointed in-graph controller shards;
- in a subprocess with 4 forced host devices, the port's
  ``experiments.run(exp, devices=4)`` against the reference's on the
  six-by-four grid of ``tests/test_sharding.py``: the same rows, the same
  ``rows.csv`` bytes and the same ``metrics.json`` bytes but
  ``n_compiles`` (the port's ``null``, the reference's 1).
"""
import dataclasses
import json
import math
import os
import textwrap
import threading
import warnings

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro.core import engine as jeng
from repro.core.metrics import schedule_table as j_schedule_table
from repro.core.ref.pydes import run_pydes as j_run_pydes
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch import experiments as texp
from repro_torch.core import engine as teng
from repro_torch.core import metrics, shard, sweep
from repro_torch.core import policy as tpol
from repro_torch.core.types import BasePolicy, EngineConfig, PSMVariant
from repro_torch.core.rl.actions import action_space_size
from repro_torch.core.rl.features import feature_size
from repro_torch.core.rl.networks import policy_init
from repro_torch.launch import sim_serve
from repro_torch.launch.sim import _CheckpointController
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

CPU = "cpu"
SCENARIOS = [60, 120, 300, 600, None]  # K = 5, the reference's pad case
GEN = dict(n_jobs=20, nb_res=16, seed=0)
SIX = tuple(f"{b} {p}" for b in ("FCFS", "EASY") for p in ("PSUS", "PSAS", "PSAS+IPM"))
SPEC = dict(workload={"preset": "fig3_small", "n_jobs": 30}, platform=16)

# the reference's and the port's experiments.run(exp, devices=4) on the
# six-by-four grid, each writing its files: rows and bytes printed back
REFERENCE_RUN = textwrap.dedent(
    """
    import json, pathlib, tempfile
    import jax
    assert jax.device_count() == 4
    from repro import experiments as jexp
    from repro.core.policy import scheduler_labels
    from repro_torch import experiments as texp
    from repro_torch.core import shard

    six = tuple(l for l in scheduler_labels() if "AlwaysOn" not in l)
    root = pathlib.Path(tempfile.mkdtemp())
    spec = dict(name="shard6x4", workload={"preset": "fig3_small", "n_jobs": 30},
                platform=16, schedulers=six, timeouts=(60, 300, 600, None))
    warm = [shard.mesh(4, "cpu").submit(d, int, 0) for d in range(4)]  # start them
    # one out directory, which metrics.json records: the reference's files
    # first, then the port's over them
    ref = jexp.run(jexp.Experiment(out=str(root), **spec), devices=4)
    files = {p: [(root / p).read_text()] for p in ("metrics.json", "rows.csv")}
    [c.result() for c in warm]
    port = texp.run(texp.Experiment(out=str(root), **spec), devices=4, device="cpu")
    for p, both in files.items():
        both.insert(0, (root / p).read_text())
    print(json.dumps({"rows": [list(port.rows), list(ref.rows)], "files": files}))
    """
)


@pytest.fixture(scope="module", autouse=True)
def reference_run():
    """The subprocess starts with the module and runs beside its other
    cases; :func:`test_devices_four_equals_the_reference_sharded_run` waits
    for it. The three CPU workers the module uses start with it too."""
    warm = [shard.mesh(3, CPU).submit(d, int, 0) for d in range(3)]
    out = {}

    def run():
        try:
            out["stdout"] = run_subprocess(REFERENCE_RUN, n_devices=4, timeout=300)
        except AssertionError as e:
            out["error"] = str(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    for c in warm:
        c.result()
    yield t, out
    t.join(timeout=300)


def _fields_equal(a, b):
    da, db = metrics.np_state(a), metrics.np_state(b)
    return [k for k in da if not (da[k].dtype == db[k].dtype
                                  and da[k].shape == db[k].shape
                                  and np.array_equal(da[k], db[k]))]


@pytest.fixture(scope="module")
def grids():
    """The unsharded port sweep, the JAX sweep and the oracle's schedules
    of K = 5 timeouts, and the sharded sweeps at D = 1, 2 and 3."""
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(**GEN))
    cfg = EngineConfig(base=BasePolicy.EASY, psm=PSMVariant.PSUS)
    jp, jw = jplat.PlatformSpec(nb_nodes=16), jgen.generate_workload(
        jgen.GeneratorConfig(**GEN))
    jcfg = JConfig(base=BasePolicy.EASY, psm=PSMVariant.PSUS)
    oracle = [j_run_pydes(jp, jw, dataclasses.replace(jcfg, timeout=t)) for t in SCENARIOS]
    return dict(
        plat=plat, wl=wl, cfg=cfg,
        ref=sweep.sweep(plat, wl, SCENARIOS, cfg, device=CPU),
        jax=jeng.sweep(jp, jw, SCENARIOS, jcfg),
        oracle=[(m, des.schedule_table()) for m, des in oracle],
        sharded={D: sweep.sweep(plat, wl, SCENARIOS, cfg, devices=D, device=CPU)
                 for D in (1, 2, 3)},
    )


@pytest.mark.parametrize("D", [1, 2, 3])
def test_sharded_rows_are_the_unsharded_rows_bit_for_bit(grids, D):
    ref, sh = grids["ref"], grids["sharded"][D]
    assert sh.devices == D and ref.devices is None and len(sh) == len(SCENARIOS)
    for f, a, b in zip(ref.states._fields, ref.states, sh.states):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f
        assert b.device.type == "cpu", f
    assert sh.rows() == ref.rows()
    for i in range(len(SCENARIOS)):
        assert _fields_equal(sh.state_at(i), ref.state_at(i)) == []


@pytest.mark.parametrize("D", [1, 2, 3])
def test_sharded_schedules_are_the_jax_sweep_and_the_oracle(grids, D):
    sh, jb = grids["sharded"][D], grids["jax"]
    for i, (m_o, table_o) in enumerate(grids["oracle"]):
        table = metrics.schedule_table(sh.state_at(i))
        np.testing.assert_array_equal(table, j_schedule_table(jb.state_at(i)))
        np.testing.assert_array_equal(table, table_o)
        assert sh[i].total_energy_j == pytest.approx(jb[i].total_energy_j, rel=1e-5)
        assert sh[i].total_energy_j == pytest.approx(m_o.total_energy_j, rel=1e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_fewer_rows_than_workers_leave_a_block_empty(grids, k):
    plat, wl, cfg = grids["plat"], grids["wl"], grids["cfg"]
    sh = sweep.sweep(plat, wl, SCENARIOS[:k], cfg, devices=3, device=CPU)
    assert sh.rows() == grids["ref"].rows()[:k] and len(sh) == k
    for i in range(k):
        assert _fields_equal(sh.state_at(i), grids["ref"].state_at(i)) == []


def test_block_bounds_cut_as_array_split():
    for n, d in [(5, 1), (5, 2), (5, 3), (5, 7), (24, 4), (0, 2)]:
        want = [(int(b[0]), int(b[-1]) + 1) if len(b) else None
                for b in np.array_split(np.arange(n), d)]
        got = shard.block_bounds(n, d)
        assert [g if g[1] > g[0] else None for g in got] == want


def test_cache_key_keeps_grid_width_and_device_count_apart(grids):
    plat, wl, cfg = grids["plat"], grids["wl"], grids["cfg"]
    sweep.clear_cache()
    runs = [(None, SCENARIOS), (None, SCENARIOS), (1, SCENARIOS), (2, SCENARIOS),
            (2, SCENARIOS), (2, SCENARIOS[:4])]
    hits = [sweep.sweep(plat, wl, sc, cfg, devices=D, device=CPU).cache_hit
            for D, sc in runs]
    assert hits == [False, True, False, False, True, False]


def test_all_is_one_on_the_cpu_and_config_devices_is_the_fallback(grids):
    plat, wl, cfg = grids["plat"], grids["wl"], grids["cfg"]
    assert sweep.sweep(plat, wl, [60], cfg, devices="all", device=CPU).devices == 1
    b = sweep.sweep(plat, wl, SCENARIOS, dataclasses.replace(cfg, devices=2), device=CPU)
    assert b.devices == 2 and b.rows() == grids["ref"].rows()


@pytest.mark.parametrize("bad", [0, -3])
def test_devices_below_one_raise_the_reference_error(grids, bad):
    with pytest.raises(ValueError, match=f"devices must be >= 1, got {bad}"):
        sweep.sweep(grids["plat"], grids["wl"], SCENARIOS, grids["cfg"], devices=bad,
                    device=CPU)


@pytest.mark.cuda
def test_devices_above_the_visible_cards_raise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = torch.cuda.device_count()
    plat = tplat.PlatformSpec(nb_nodes=8)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=8, nb_res=8, seed=0))
    with pytest.raises(ValueError, match=f"devices={n + 1} exceeds the {n} visible"):
        sweep.sweep(plat, wl, [60], EngineConfig(), devices=n + 1)


def test_the_sharded_handle_is_asynchronous_and_counts_the_workers_reads(grids):
    plat, wl, cfg = grids["plat"], grids["wl"], grids["cfg"]
    blocks = [SCENARIOS[lo:hi] for lo, hi in shard.block_bounds(len(SCENARIOS), 2)]
    teng.HOST_SYNCS = 0
    for b in blocks:
        sweep.sweep(plat, wl, b, cfg, device=CPU)
    want = teng.HOST_SYNCS
    teng.HOST_SYNCS = 0
    pending = sweep.sweep_async(plat, wl, SCENARIOS, cfg, devices=2, device=CPU)
    assert pending._batch is None and teng.HOST_SYNCS == 0  # nothing gathered yet
    batch = pending.result()
    assert pending.result() is batch and teng.HOST_SYNCS == want > 0
    assert batch.rows() == grids["ref"].rows()


def test_truncated_rows_warn_once_gathered(grids):
    plat, wl = grids["plat"], grids["wl"]
    cfg = dataclasses.replace(grids["cfg"], max_batches=5)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        b = sweep.sweep(plat, wl, SCENARIOS, cfg, devices=2, device=CPU)
    assert bool(b.states.truncated.all())
    assert sum("PARTIAL" in str(r.message) for r in rec) == 1


def test_what_cannot_cross_a_process_boundary_is_refused(grids):
    with pytest.raises(ValueError, match="meta tensor .* cannot cross"):
        shard.dumps(torch.empty(2, device="meta"))
    ctrl = tpol.RLController(controller=lambda s, const: (None, None))
    cfg = EngineConfig(policy=ctrl, rl_decision_interval=600)
    with pytest.raises(ValueError, match="in-graph controller .* does not pickle"):
        sweep.sweep(grids["plat"], grids["wl"], ["EASY RL", "EASY PSUS"], cfg, devices=2,
                    device=CPU)


def test_moves_keep_layout_and_sharing():
    base = torch.arange(10.0).reshape(2, 5)
    tree = {"wide": base[None].expand(3, 2, 5), "same": [base, base], "n": 3}
    moved = shard.to_device(tree, "meta")
    assert moved["wide"].stride() == (0, 5, 1) and moved["wide"].device.type == "meta"
    assert moved["same"][0] is moved["same"][1] and moved["n"] == 3
    assert shard.to_host(tree)["same"][0] is base  # a CPU tensor stays as it is


# (platform, feature, action, grouped, groups, scenarios): the sweep's
# controller cases (tests/test_torch_sweep_forecast.py)
CONTROLLERS = {
    "RL:groups": (tplat.mixed_platform_example(16), "compact_groups",
                  "group_target_fraction", True, 3,
                  ["EASY RL:groups", "FCFS RL:groups", "EASY PSUS",
                   {"scheduler": "EASY RL:groups", "timeout": 60}, "EASY PSAS+IPM"]),
    "RL": (tplat.PlatformSpec(nb_nodes=16), "compact", "target_fraction", False, 1,
           ["EASY RL", "EASY PSUS+Forecast", {"scheduler": "FCFS RL", "timeout": 900}]),
}


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_the_checkpointed_controller_shards(name):
    """``launch/sim``'s controller (a seeded policy with random heads)
    crosses to the workers and drives their RL rows."""
    plat, feature, action, grouped, groups, scenarios = CONTROLLERS[name]
    gen = torch.Generator().manual_seed(3)
    params = policy_init(gen, feature_size(feature, 8, groups),
                         action_space_size(action, 9, groups), (16, 16))
    with torch.no_grad():
        for p in params.parameters():
            p.add_(torch.randn(p.shape, generator=gen))
    ctrl = _CheckpointController(params, dict(feature=feature, action=action,
                                              n_levels=9, feature_window=8))
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=20, nb_res=16, seed=11))
    cfg = EngineConfig(policy=tpol.RLController(grouped=grouped, controller=ctrl),
                       grouped_tables=groups > 1, rl_decision_interval=600,
                       timeout=300, node_order="cheap")
    ref = sweep.sweep(plat, wl, scenarios, cfg, device=CPU)
    sh = sweep.sweep(plat, wl, scenarios, cfg, devices=2, device=CPU)
    for i in range(len(scenarios)):
        assert _fields_equal(sh.state_at(i), ref.state_at(i)) == [], scenarios[i]
    assert sh.rows() == ref.rows()


def _files(out):
    return {p: (out / p).read_bytes() for p in ("metrics.json", "rows.csv")}


@pytest.fixture(scope="module")
def unsharded_files(tmp_path_factory):
    """The unsharded run's rows and files; the sharded runs write into the
    same directory, which ``metrics.json`` records."""
    out = tmp_path_factory.mktemp("runner")
    exp = texp.Experiment(name="six", schedulers=SIX, timeouts=(60, 600), out=str(out),
                          **SPEC)
    return exp, texp.run(exp, device=CPU), _files(out), out


@pytest.mark.parametrize("D", [2, 3])
def test_the_blocking_runner_writes_the_unsharded_bytes(unsharded_files, D):
    exp, ref, files, out = unsharded_files
    got = texp.run(exp, devices=D, device=CPU)
    assert list(got.rows) == list(ref.rows) and _files(out) == files


def test_the_streamed_runner_keeps_its_order_per_chunk(unsharded_files):
    exp, ref, files, out = unsharded_files
    sr = texp.run(exp, devices=2, stream=True, chunk_scenarios=5, device=CPU)
    chunks = []
    for c in sr:
        chunks.append(c)
        assert json.loads((out / "metrics.json").read_text())["rows"] == [
            r for ch in chunks for r in ch]
    assert [len(c) for c in chunks] == [5, 5, 2]
    assert [r for c in chunks for r in c] == list(ref.rows)
    assert _files(out) == files


def test_the_service_shards_each_launch(tmp_path):
    spec = dict(schedulers=["EASY PSUS", "FCFS PSAS"], timeouts=(60, 600), **SPEC)
    got = {}
    for devices in (None, 2):  # one out root, which metrics.json records
        service = sim_serve.SimService(str(tmp_path), devices=devices,
                                       chunk_scenarios=3, device=CPU)
        for name in ("user-a", "user-b"):
            service.submit(name, texp.Experiment(name=name, **spec))
        got[devices] = [(r, _files(tmp_path / r["request"])) for r in service.drain()]
    assert [r["devices"] for r, _ in got[2]] == [2, 2]
    assert [r["devices"] for r, _ in got[None]] == [None, None]
    for (ra, fa), (rb, fb) in zip(got[None], got[2]):
        assert rb["status"] == "done" and rb["request"] == ra["request"]
        assert (rb["rows"], rb["chunks"]) == (ra["rows"], ra["chunks"]) == (4, 2)
        assert fb == fa


def test_devices_four_equals_the_reference_sharded_run(reference_run):
    thread, out = reference_run
    thread.join(timeout=300)
    assert not thread.is_alive(), "the reference run did not finish in 300 s"
    assert "error" not in out, out.get("error")
    got = json.loads(out["stdout"].strip().splitlines()[-1])
    port_rows, ref_rows = got["rows"]
    assert len(port_rows) == 24 and port_rows == ref_rows
    port_csv, ref_csv = got["files"]["rows.csv"]
    assert port_csv == ref_csv
    port_json, ref_json = got["files"]["metrics.json"]
    assert '"n_compiles": null' in port_json and '"n_compiles": 1' in ref_json
    assert port_json.replace('"n_compiles": null', '"n_compiles": 1') == ref_json


def test_a_workers_exception_and_death_raise_in_the_parent():
    with pytest.raises(ValueError, match="math domain error") as e:
        shard.mesh(1, CPU).submit(0, math.sqrt, -1.0).result()
    assert "Traceback" in str(e.value.__cause__)  # the worker's traceback
    # the module's last case: the worker it kills serves no later one
    with pytest.raises(RuntimeError, match="died before it answered"):
        shard.mesh(1, CPU).submit(0, os._exit, 3).result()
    assert (CPU, 0, 0) not in shard._WORKERS
