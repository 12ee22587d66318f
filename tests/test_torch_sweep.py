"""The PyTorch port's batched sweep (``repro_torch.core.sweep``) on the CPU:
each row against the port's own single run of its scenario (bit for bit on
every ``SimState`` field, the schedule table and the metrics row), against
the JAX reference's ``engine.sweep`` (the same schedule; energy to rel 1e-5,
the bar of the reference's SEMANTICS.md §Numerics) and against the port's
copy of the oracle; rows that stop at different batches, truncation per
row, quiet and full batches in one iteration, FCFS and EASY rows in one
pass, the launch and host-read counts per iteration, the cache counters,
every rejection, and the module's isolation from jax and ``repro``.
"""
import dataclasses
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.metrics import np_state as j_np_state
from repro.core.metrics import schedule_table as j_schedule_table
from repro.core.types import EngineConfig as JConfig
from repro.workloads import generator as jgen
from repro.workloads import platform as jplat
from repro_torch.core import convert, metrics, sweep
from repro_torch.core import engine as teng
from repro_torch.core import policy as tpol
from repro_torch.core.ref.pydes import run_pydes
from repro_torch.core.types import BasePolicy, EngineConfig, PSMVariant
from repro_torch.kernels import event_fuse
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SEVEN = [f"{b} {p}" for b in ("FCFS", "EASY") for p in ("PSUS", "PSAS", "PSAS+IPM")] + [
    "EASY AlwaysOn"]
TIMEOUTS = [60, 300, 900, 1800, 2400, 3600, None]


def _cfg(label, **kw):
    b, p = tpol.from_label(label)
    return EngineConfig(base=b, policy=p, **kw)


def _fields_equal(a, b):
    """The SimState fields where ``a`` and ``b`` differ in dtype, shape or
    value (bit for bit)."""
    da, db = metrics.np_state(a), metrics.np_state(b)
    assert set(da) == set(db)
    return [k for k in da if not (da[k].dtype == db[k].dtype
                                  and da[k].shape == db[k].shape
                                  and np.array_equal(da[k], db[k]))]


# --------------------------------------------------------------------------
# every row == the port's single run of its scenario
# --------------------------------------------------------------------------

HOT = tplat.PlatformSpec(nb_nodes=16, power_idle=250.0)


@pytest.fixture(scope="module")
def policy_api_grids():
    """The reference's ``test_sweep_matches_individual_simulate`` grid: 7
    timeouts and a hot-idle platform, dense and grouped."""
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=50, nb_res=16, seed=2))
    out = {}
    for grouped in (False, True):
        cfg = EngineConfig(base=BasePolicy.EASY, psm=PSMVariant.PSUS, timeout=300,
                           window=24, grouped_tables=grouped)
        out[grouped] = (plat, wl, cfg, sweep.sweep(plat, wl, TIMEOUTS + [HOT], cfg,
                                                   device=CPU))
    return out


@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
@pytest.mark.parametrize("row", range(len(TIMEOUTS) + 1))
def test_each_row_is_its_single_run_bit_for_bit(policy_api_grids, grouped, row):
    plat, wl, cfg, batch = policy_api_grids[grouped]
    if row < len(TIMEOUTS):
        run_plat, run_cfg = plat, dataclasses.replace(cfg, timeout=TIMEOUTS[row])
    else:
        run_plat, run_cfg = HOT, cfg
    single = teng.simulate(run_plat, wl, run_cfg, device=CPU)
    got = batch.state_at(row)
    assert _fields_equal(got, single) == []
    np.testing.assert_array_equal(metrics.schedule_table(got),
                                  metrics.schedule_table(single))
    assert batch[row].row() == metrics.metrics_from_state(single, run_plat).row()
    assert batch.rows()[row] == batch[row].row()
    assert batch.n_compiles is None and batch.devices is None and len(batch) == 8


def test_hot_idle_platform_row_draws_more():
    """The platform scenario's watts reach its row: a 250 W idle draw costs
    more than the 300 s timeout's row of the default platform."""
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=20, nb_res=16, seed=2))
    b = sweep.sweep(plat, wl, [300, HOT], EngineConfig(timeout=300), device=CPU)
    assert b[1].total_energy_j > b[0].total_energy_j


@pytest.mark.parametrize("grouped", [False, True], ids=["ledger", "occ"])
def test_platform_rows_take_the_kernels_per_row_tables(monkeypatch, grouped):
    """On the kernel route (``fused_kernel=True``: the wrappers' plain
    versions on the CPU) a platform scenario hands the event wrapper one
    table a row, ``[E, 5]`` watts or ``[E, N]`` group ids, and each row is
    still its single run bit for bit."""
    if grouped:
        # the same three groups split 2 / 5 / 5: other group ids a node
        plat = tplat.mixed_platform_example(12)
        other = tplat.platform_from_groups(tuple(
            dataclasses.replace(grp, count=c) for grp, c in zip(plat.node_groups, (2, 5, 5))
        ))
    else:
        plat, other = tplat.PlatformSpec(nb_nodes=16), HOT
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=40, nb_res=plat.nb_nodes,
                                                     seed=6))
    cfg = EngineConfig(timeout=120, fused_kernel=True, grouped_tables=grouped,
                       node_order="cheap" if grouped else "id")
    name, arg = ("event_fuse_occ", 3) if grouped else ("event_fuse_ledger", 3)
    shapes = []
    real = getattr(event_fuse, name)
    monkeypatch.setattr(event_fuse, name,
                        lambda *a: shapes.append(tuple(a[arg].shape)) or real(*a))
    b = sweep.sweep(plat, wl, [plat, other], cfg, device=CPU)
    assert set(shapes) == {(2, 5) if not grouped else (2, plat.nb_nodes)}
    monkeypatch.undo()
    for i, p in enumerate([plat, other]):
        assert _fields_equal(b.state_at(i), teng.simulate(p, wl, cfg, device=CPU)) == []


# --------------------------------------------------------------------------
# against the JAX reference's sweep and the oracle
# --------------------------------------------------------------------------

JAX_CASES = {
    # seven labels x 2 timeouts on 16 homogeneous nodes, dense
    "dense": dict(nodes=16, mixed=False, jobs=50, seed=2, order="id", grouped=False),
    # the same on the 12-node mixed platform, grouped, cheapest nodes first
    # (the reference's test_grouped_bit_exact_traced_sweep)
    "grouped": dict(nodes=12, mixed=True, jobs=40, seed=7, order="cheap", grouped=True),
}
JAX_SCENARIOS = [{"scheduler": label, "timeout": t} for label in SEVEN for t in (90, 900)]


@pytest.fixture(scope="module")
def jax_grids():
    """One JAX sweep and one port sweep per case."""
    out = {}
    for name, c in JAX_CASES.items():
        mk = "mixed_platform_example" if c["mixed"] else None
        jp = (getattr(jplat, mk)(c["nodes"]) if mk
              else jplat.PlatformSpec(nb_nodes=c["nodes"]))
        tp = (getattr(tplat, mk)(c["nodes"]) if mk
              else tplat.PlatformSpec(nb_nodes=c["nodes"]))
        gen = dict(n_jobs=c["jobs"], nb_res=c["nodes"], seed=c["seed"], overrun_prob=0.2)
        jw = jgen.generate_workload(jgen.GeneratorConfig(**gen))
        tw = tgen.generate_workload(tgen.GeneratorConfig(**gen))
        kw = dict(timeout=300, node_order=c["order"], grouped_tables=c["grouped"],
                  terminate_overrun=True)
        jb = jeng.sweep(jp, jw, JAX_SCENARIOS, JConfig(**kw))
        tb = sweep.sweep(tp, tw, JAX_SCENARIOS, EngineConfig(**kw), device=CPU)
        out[name] = (tp, tw, kw, jb, tb)
    return out


@pytest.mark.parametrize("case", list(JAX_CASES))
@pytest.mark.parametrize("row", range(len(JAX_SCENARIOS)))
def test_rows_match_the_jax_sweep(jax_grids, case, row):
    tp, tw, kw, jb, tb = jax_grids[case]
    np.testing.assert_array_equal(metrics.schedule_table(tb.state_at(row)),
                                  j_schedule_table(jb.state_at(row)))
    jm, tm = jb[row], tb[row]
    assert tm.makespan_s == jm.makespan_s and tm.mean_wait_s == jm.mean_wait_s
    assert tm.total_energy_j == pytest.approx(jm.total_energy_j, rel=1e-5)
    assert tm.wasted_energy_j == pytest.approx(jm.wasted_energy_j, rel=1e-5)
    assert tm.truncated == jm.truncated is False


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_stacked_jax_states_carry_into_the_port_and_back(jax_grids, case):
    """``convert``: the reference's stacked ``SimBatch.states`` become the
    port's ``[E]`` state and come back row by row; the port's sweep agrees
    with it field for field (integers exactly, f32 to rel 1e-5)."""
    tp, tw, kw, jb, tb = jax_grids[case]
    stacked = j_np_state(jb.states)
    carried = convert.state_from_arrays(stacked, device=CPU)
    assert carried.node_state.shape == (len(JAX_SCENARIOS), tp.nb_nodes)
    rows = convert.state_rows_to_arrays(carried)
    assert len(rows) == len(JAX_SCENARIOS)
    for i, row in enumerate(rows):
        for k, v in row.items():
            np.testing.assert_array_equal(v, stacked[k][i], err_msg=k)
    mine = convert.state_rows_to_arrays(tb.states)
    for i, (want, got) in enumerate(zip(rows, mine)):
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if want[k].dtype == np.float32:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-3,
                                           err_msg=f"row {i} {k}")
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"row {i} {k}")


@pytest.mark.parametrize("case,row", [("dense", 4), ("dense", 11), ("dense", 13),
                                      ("grouped", 0), ("grouped", 9)])
def test_rows_match_the_oracle(jax_grids, case, row):
    tp, tw, kw, jb, tb = jax_grids[case]
    sc = JAX_SCENARIOS[row]
    cfg = _cfg(sc["scheduler"], **{**kw, "timeout": sc["timeout"]})
    m_o, des = run_pydes(tp, tw, cfg)
    np.testing.assert_array_equal(metrics.schedule_table(tb.state_at(row)),
                                  des.schedule_table())
    assert tb[row].total_energy_j == pytest.approx(m_o.total_energy_j, rel=1e-5)


# --------------------------------------------------------------------------
# rows that stop apart, truncation, quiet and full batches, FCFS with EASY
# --------------------------------------------------------------------------

def _spread_grid():
    """Rows whose runs end over a hundred batches apart: AlwaysOn has no
    switching, a 10 s timeout switches nodes after nearly every job."""
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=100, nb_res=16, seed=5))
    return plat, wl, ["EASY AlwaysOn", {"scheduler": "FCFS PSAS", "timeout": 10},
                      {"scheduler": "EASY PSUS", "timeout": 900}]


def _single(plat, wl, sc, **kw):
    if isinstance(sc, str):
        return teng.simulate(plat, wl, _cfg(sc, timeout=300, **kw), device=CPU)
    return teng.simulate(plat, wl, _cfg(sc["scheduler"], timeout=sc["timeout"], **kw),
                         device=CPU)


def test_rows_that_end_apart_keep_their_own_batches_and_energy():
    plat, wl, scen = _spread_grid()
    b = sweep.sweep(plat, wl, scen, EngineConfig(timeout=300), device=CPU)
    nb = b.states.n_batches.tolist()
    assert max(nb) - min(nb) >= 150, nb
    for i, sc in enumerate(scen):
        assert _fields_equal(b.state_at(i), _single(plat, wl, sc)) == []


def test_truncation_is_per_row_and_named():
    plat, wl, scen = _spread_grid()
    full = sweep.sweep(plat, wl, scen, EngineConfig(timeout=300), device=CPU)
    nb = full.states.n_batches.tolist()
    cap = sorted(nb)[1] - 1  # the shortest row ends, the two others are cut
    cut = [i for i, n in enumerate(nb) if n > cap]
    with pytest.warns(RuntimeWarning, match=re.escape(f"sweep scenario(s) {cut} hit the batch cap")):
        b = sweep.sweep(plat, wl, scen, EngineConfig(timeout=300, max_batches=cap),
                        device=CPU)
    assert b.states.truncated.tolist() == [n > cap for n in nb]
    assert [m.truncated for m in b.metrics] == [n > cap for n in nb]
    for i, sc in enumerate(scen):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            single = _single(plat, wl, sc, max_batches=cap)
        assert _fields_equal(b.state_at(i), single) == []


def _loop_reads(monkeypatch, e):
    """Record the host values of each loop read (``4 E`` of them)."""
    seen = []
    real = teng._read

    def spy(*values):
        out = real(*values)
        if len(out) == 4 * e:
            seen.append(out)
        return out

    monkeypatch.setattr(teng, "_read", spy)
    return seen


def test_a_quiet_row_rides_a_full_batch_of_the_others(monkeypatch):
    """Iterations where only some live rows are quiet run the full batch on
    all of them; iterations where every live row is quiet run the quiet
    body. Both happen here, and every row is its single run."""
    plat, wl, scen = _spread_grid()
    reads = _loop_reads(monkeypatch, len(scen))
    quiet_bodies = []
    real_quiet = sweep._quiet_batch
    monkeypatch.setattr(sweep, "_quiet_batch",
                        lambda s, g: quiet_bodies.append(1) or real_quiet(s, g))
    b = sweep.sweep(plat, wl, scen, EngineConfig(timeout=300), device=CPU)
    E = len(scen)
    mixed = 0
    for host in reads:
        nt, done, quiet, nb = (host[i * E:(i + 1) * E] for i in range(4))
        live = [not d and x < 2**30 and n < 10**9 for x, d, n in zip(nt, done, nb)]
        q = [qq for qq, l in zip(quiet, live) if l]
        mixed += bool(q) and any(q) and not all(q)
    assert mixed > 0 and len(quiet_bodies) > 0
    monkeypatch.undo()
    for i, sc in enumerate(scen):
        assert _fields_equal(b.state_at(i), _single(plat, wl, sc)) == []


def test_fcfs_and_easy_rows_share_each_pass(monkeypatch):
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=80, nb_res=16, seed=3))
    scen = [{"scheduler": s, "timeout": 600} for s in
            ("FCFS PSUS", "EASY PSUS", "FCFS PSAS+IPM", "EASY PSAS")]
    plans = []
    real = sweep._plan_pass
    monkeypatch.setattr(sweep, "_plan_pass",
                        lambda *a: plans.append(real(*a)) or plans[-1])
    b = sweep.sweep(plat, wl, scen, EngineConfig(timeout=300), device=CPU)
    # some pass had backfill attempts (EASY rows) while an FCFS row stopped
    assert any(p.backfill_steps for p in plans)
    assert not np.array_equal(metrics.schedule_table(b.state_at(0)),
                              metrics.schedule_table(b.state_at(1)))
    for i, sc in enumerate(scen):
        assert _fields_equal(b.state_at(i), _single(plat, wl, sc)) == []


# --------------------------------------------------------------------------
# the analogue of one program per grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grouped", [False, True], ids=["ledger", "occ"])
def test_one_kernel_call_and_the_same_host_reads_per_iteration_at_any_width(
        monkeypatch, grouped):
    """With ``fused_kernel=True`` (the wrapper's plain version on the CPU)
    the grid makes one event-wrapper call per iteration, and a grid of 8
    copies of a scenario makes exactly the host reads of 1 copy, which are
    the single run's."""
    plat = tplat.curie_platform(30) if grouped else tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=60, nb_res=plat.nb_nodes,
                                                     seed=1))
    cfg = _cfg("EASY PSAS+IPM", timeout=120, fused_kernel=True, grouped_tables=grouped)
    name = "event_fuse_occ" if grouped else "event_fuse_ledger"
    calls = []
    real = getattr(event_fuse, name)
    monkeypatch.setattr(event_fuse, name, lambda *a: calls.append(1) or real(*a))
    counts = {}
    for e in (1, 8):
        calls.clear()
        teng.HOST_SYNCS = 0
        b = sweep.sweep(plat, wl, [120] * e, cfg, device=CPU)
        iters = int(b.states.n_batches.max())
        counts[e] = (len(calls), teng.HOST_SYNCS, iters)
        assert len(calls) == iters
        assert teng.HOST_SYNCS <= 2 * iters
    calls.clear()
    teng.HOST_SYNCS = 0
    single = teng.simulate(plat, wl, cfg, device=CPU)
    assert counts[1] == counts[8] == (len(calls), teng.HOST_SYNCS, int(single.n_batches))


def test_attempts_per_pass_stay_within_the_window(monkeypatch):
    """A mixed grid of 14 rows attempts at most W times a pass in all, and
    makes at most two host reads an iteration."""
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=60, nb_res=16, seed=9))
    W = 8
    per_pass, attempts = [], []
    real_try, real_pass = sweep._try_allocate, sweep._scheduler_pass

    def try_spy(*a, **k):
        attempts.append(1)
        return real_try(*a, **k)

    def pass_spy(*a, **k):
        attempts.clear()
        out = real_pass(*a, **k)
        per_pass.append(len(attempts))
        return out

    monkeypatch.setattr(sweep, "_try_allocate", try_spy)
    monkeypatch.setattr(sweep, "_scheduler_pass", pass_spy)
    teng.HOST_SYNCS = 0
    b = sweep.sweep(plat, wl, JAX_SCENARIOS, EngineConfig(timeout=300, window=W),
                    device=CPU)
    iters = int(b.states.n_batches.max())
    assert max(per_pass) <= W and sum(per_pass) > 0
    assert teng.HOST_SYNCS <= 2 * iters


# --------------------------------------------------------------------------
# the host API: cache counters, async handle, rejections, isolation
# --------------------------------------------------------------------------

def test_cache_stats_tick_and_key_separation():
    plat = tplat.PlatformSpec(nb_nodes=8)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=12, nb_res=8, seed=4))
    cfg = EngineConfig(base=BasePolicy.EASY, psm=PSMVariant.PSUS, window=7)
    scenarios = [60, 600]
    s0 = sweep.cache_stats()
    first = sweep.sweep(plat, wl, scenarios, cfg, device=CPU)
    s1 = sweep.cache_stats()
    again = sweep.sweep(plat, wl, scenarios, cfg, device=CPU)
    s2 = sweep.cache_stats()
    one = sweep.sweep(plat, wl, scenarios, cfg, devices=1, device=CPU)
    s3 = sweep.cache_stats()
    wider = sweep.sweep(plat, wl, scenarios + [None], cfg, device=CPU)
    s4 = sweep.cache_stats()
    assert s1["sweep_misses"] == s0["sweep_misses"] + 1 and not first.cache_hit
    assert s2 == {**s1, "sweep_hits": s1["sweep_hits"] + 1} and again.cache_hit
    # devices=1 and another grid width are other keys: misses, not reuses
    assert s3["sweep_misses"] == s2["sweep_misses"] + 1 and not one.cache_hit
    assert s4["sweep_misses"] == s3["sweep_misses"] + 1 and not wider.cache_hit
    assert one.devices == 1 and first.devices is None
    for ma, mb in zip(first.metrics, one.metrics):
        assert ma.row() == mb.row()


def test_sweep_async_hands_back_the_finished_batch():
    plat = tplat.PlatformSpec(nb_nodes=8)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=12, nb_res=8, seed=4))
    cfg = EngineConfig(base=BasePolicy.EASY, psm=PSMVariant.PSUS)
    pending = sweep.sweep_async(plat, wl, [60, 600], cfg, device=CPU)
    batch = pending.result()
    assert pending.result() is batch
    ref = sweep.sweep(plat, wl, [60, 600], cfg, device=CPU)
    assert batch.rows() == ref.rows()


def _controller(s, const):
    return torch.zeros_like(s.rl_on_cmd), torch.zeros_like(s.rl_off_cmd)


@pytest.mark.parametrize("scenarios,exc,msg", [
    ([tplat.PlatformSpec(nb_nodes=8)], ValueError, "share node count"),
    ([tplat.mixed_platform_example(16)], ValueError, "share node count, group count"),
    ([], ValueError, "at least one scenario"),
    ([object()], TypeError, "unsupported sweep scenario"),
    ([{"bogus": 1}], TypeError, "unknown sweep scenario key"),
    ([{"tables": None}], TypeError, "cannot override 'tables'"),
    ([{"platform": 16}], TypeError, "scenario 'platform' must be a PlatformSpec"),
    ([{"speed": "fast"}], TypeError, "invalid value for sweep scenario key 'speed'"),
    ([tpol.RLController(controller=_controller)], ValueError, "controller"),
])
def test_scenario_rejections_keep_the_reference_messages(scenarios, exc, msg):
    plat = tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=10, nb_res=16, seed=0))
    with pytest.raises(exc, match=msg):
        sweep.sweep(plat, wl, scenarios, EngineConfig(timeout=300), device=CPU)


def test_dvfs_mode_width_must_match():
    plat = tplat.mixed_platform_example(16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=10, nb_res=16, seed=0))
    other = tplat.dvfs_platform_example(16)
    assert other.n_dvfs_modes() != plat.n_dvfs_modes()
    with pytest.raises(ValueError, match="DVFS mode-table width"):
        sweep.sweep(plat, wl, [other], EngineConfig(timeout=300), device=CPU)


def test_devices_all_is_one_on_the_cpu():
    plat = tplat.PlatformSpec(nb_nodes=8)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=8, nb_res=8, seed=0))
    assert sweep.sweep(plat, wl, [60], EngineConfig(), devices="all",
                       device=CPU).devices == 1


def test_sweep_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for its absence")
    plat = tplat.PlatformSpec(nb_nodes=8)
    wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=5, nb_res=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.sweep(plat, wl, [60], EngineConfig())


def test_traced_flags_stack_into_rows():
    pp = [tpol.from_label(label)[1].params(tpol.from_label(label)[0]) for label in SEVEN]
    stacked = tpol.stack_params([p.traced(CPU) for p in pp], CPU)
    for i, name in enumerate(tpol.PolicyParams._fields):
        col = getattr(stacked, name)
        assert col.dtype == torch.bool and col.shape == (len(SEVEN),)
        assert col.tolist() == [bool(p[i]) for p in pp]
    assert tpol.static_bool(stacked.backfill) is None


def test_sweep_module_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import repro_torch.core.sweep\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""
