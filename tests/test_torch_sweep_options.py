"""The PyTorch port's batched sweep under the engine options a grid study can
ask for: ``node_order="pack"``, ``allocation="partition"`` and
``merge_bursts``, each alone and all three together, on the dense path (the
16-node mixed DVFS platform) and the grouped path (a 36-node
``curie_platform``), on the CPU.

Each grid's eight rows (FCFS and EASY under rules 6-7, an RL row without a
controller, a Forecast row and a DVFS row) equal the port's single run of
their scenario bit for bit, and the JAX reference's ``engine.sweep`` row
(schedule and counters exact; energy to rel 1e-5, the DVFS mode ledger to
rel 1e-4 on the dense route, ROADMAP Queue 3 item 4); two rows equal the
port's copy of the oracle. Then what the loop costs: a pass's host reads
against the single runs' (at most one window read, one read a step
with a partition head attempt, one a merge repeat, each over every row),
one event-wrapper call an iteration, and ``policy.pack_key_rows`` against
``pack_key`` row by row.
"""
import dataclasses

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
from repro_torch.core.types import IDLE, EngineConfig
from repro_torch.kernels import event_fuse
from repro_torch.workloads import generator as tgen
from repro_torch.workloads import platform as tplat

CPU = "cpu"
SCENARIOS = [
    {"scheduler": "FCFS PSUS", "timeout": 60},
    {"scheduler": "EASY PSUS", "timeout": 300},
    {"scheduler": "FCFS PSAS+IPM", "timeout": 600},
    {"scheduler": "EASY PSAS", "timeout": 900},
    {"scheduler": "EASY AlwaysOn", "timeout": 300},
    {"scheduler": "EASY RL", "timeout": 300},
    {"scheduler": "EASY PSUS+Forecast", "timeout": 300},
    {"scheduler": "EASY DVFS", "timeout": 600},
]
# the paths: platform, generator settings (jobs no wider than the widest
# group, so partition rows run them, but wider than most groups, so heads
# that fit the unreserved count can find no group), grouped tables
PATHS = {
    "dense": (lambda m: m.dvfs_platform_example(16),
              dict(n_jobs=30, nb_res=16, max_res=6, mean_interarrival=60.0, seed=4),
              False),
    "grouped": (lambda m: m.curie_platform(36),
                dict(n_jobs=30, nb_res=36, max_res=12, mean_interarrival=60.0, seed=4),
                True),
}
# the window is narrow where bursts merge, so a burst outgrows it
OPTIONS = {
    "pack": dict(node_order="pack"),
    "partition": dict(allocation="partition"),
    "merge": dict(merge_bursts=True, window=3),
    "all": dict(node_order="pack", allocation="partition", merge_bursts=True, window=4),
}
BASE = dict(timeout=300, terminate_overrun=True, rl_decision_interval=600,
            forecast_horizon=900)
GRIDS = [(o, p) for o in OPTIONS for p in PATHS]


def _inputs(path):
    plat_fn, gen, grouped = PATHS[path]
    return (plat_fn(tplat), tgen.generate_workload(tgen.GeneratorConfig(**gen)),
            plat_fn(jplat), jgen.generate_workload(jgen.GeneratorConfig(**gen)), grouped)


def _single_cfg(cfg, sc):
    base, pol = tpol.from_label(sc["scheduler"])
    return dataclasses.replace(cfg, base=base, policy=pol, timeout=sc["timeout"])


def _bad_fields(a, b):
    da, db = metrics.np_state(a), metrics.np_state(b)
    return [k for k in da if not (da[k].dtype == db[k].dtype
                                  and np.array_equal(da[k], db[k]))]


@pytest.fixture(scope="module")
def grids():
    """Every (options, path) grid through the port's sweep and the JAX
    reference's, built once for the module."""
    out = {}
    for opt, path in GRIDS:
        tp, tw, jp, jw, grouped = _inputs(path)
        kw = dict(BASE, grouped_tables=grouped, **OPTIONS[opt])
        cfg = EngineConfig(**kw)
        out[opt, path] = (tp, tw, cfg, sweep.sweep(tp, tw, SCENARIOS, cfg, device=CPU),
                          jeng.sweep(jp, jw, SCENARIOS, JConfig(**kw)))
    return out


@pytest.mark.parametrize("opt,path", GRIDS)
@pytest.mark.parametrize("row", range(len(SCENARIOS)))
def test_rows_are_their_single_runs_and_the_jax_sweep(grids, opt, path, row):
    tp, tw, cfg, batch, jbatch = grids[opt, path]
    sc = SCENARIOS[row]
    single = teng.simulate(tp, tw, _single_cfg(cfg, sc), device=CPU)
    got = batch.state_at(row)
    assert _bad_fields(got, single) == [], sc
    assert batch[row].row() == metrics.metrics_from_state(single, tp).row()
    jrow = jeng.SimState(*[x[row] for x in jbatch.states])
    np.testing.assert_array_equal(metrics.schedule_table(got), j_schedule_table(jrow))
    a, j = metrics.np_state(got), j_np_state(jrow)
    for k in ("n_batches", "n_allocs", "n_switch_on", "n_switch_off", "dvfs_mode",
              "job_status", "job_finish", "node_job"):
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)
    np.testing.assert_allclose(a["energy"], j["energy"], rtol=1e-5, atol=1e-3)
    mode_rtol = 1e-5 if cfg.grouped_tables else 1e-4
    np.testing.assert_allclose(a["mode_energy"], j["mode_energy"], rtol=mode_rtol,
                               atol=1e-3)
    assert batch[row].truncated is jbatch[row].truncated is False


@pytest.mark.parametrize("path,row", [("dense", 1), ("grouped", 2)])
def test_rows_match_the_oracle(grids, path, row):
    tp, tw, cfg, batch, _ = grids["all", path]
    m_o, des = run_pydes(tp, tw, _single_cfg(cfg, SCENARIOS[row]))
    np.testing.assert_array_equal(metrics.schedule_table(batch.state_at(row)),
                                  des.schedule_table())
    assert batch[row].total_energy_j == pytest.approx(m_o.total_energy_j, rel=1e-5)


def test_the_options_change_the_schedule(grids):
    """Each option moves some row's schedule off the plain grid's, so the
    rows above hold the options, not a grid that ignores them."""
    for path in PATHS:
        tp, tw, _, _, grouped = _inputs(path)
        plain = sweep.sweep(tp, tw, SCENARIOS, EngineConfig(**BASE, grouped_tables=grouped),
                            device=CPU)
        for opt in OPTIONS:
            b = grids[opt, path][3]
            assert any(
                not np.array_equal(metrics.schedule_table(b.state_at(i)),
                                   metrics.schedule_table(plain.state_at(i)))
                for i in range(len(SCENARIOS))
            ), (opt, path)


# --------------------------------------------------------------------------
# what a pass reads, what an iteration launches
# --------------------------------------------------------------------------

def _pass_reads(monkeypatch, module):
    """Spy on ``module._scheduler_pass`` and ``module._run_pass``: for each
    scheduler pass, (batch index, host reads of the pass, reads made inside
    each of its ``_run_pass`` calls)."""
    calls = []
    real_pass, real_run = module._scheduler_pass, module._run_pass

    def pass_spy(s, *a, **k):
        before = teng.HOST_SYNCS
        calls.append([int(s.n_batches.max()), 0, []])
        out = real_pass(s, *a, **k)
        calls[-1][1] = teng.HOST_SYNCS - before
        return out

    def run_spy(*a, **k):
        before = teng.HOST_SYNCS
        out = real_run(*a, **k)
        calls[-1][2].append(teng.HOST_SYNCS - before)
        return out

    monkeypatch.setattr(module, "_scheduler_pass", pass_spy)
    monkeypatch.setattr(module, "_run_pass", run_spy)
    return calls


@pytest.mark.parametrize("opt", ["partition", "merge", "all"])
@pytest.mark.parametrize("path", list(PATHS))
def test_a_pass_reads_no_more_than_its_rows_single_runs(monkeypatch, path, opt):
    """Each scheduler pass of the grid makes at most 1 + (steps with a
    partition head attempt) + (one read a merge repeat) host reads, each
    over every row: from the single runs, with h[e][p] the reads of row e's
    p-th pass of that batch and m[e] its repeat-condition reads, the grid's
    pass reads at most 1 + sum over p of max_e h[e][p] + max_e m[e]. Without
    merging that is the single run of the row that reads most."""
    tp, tw, _, _, grouped = _inputs(path)
    cfg = EngineConfig(**BASE, grouped_tables=grouped, **OPTIONS[opt])
    batched = _pass_reads(monkeypatch, sweep)
    b = sweep.sweep(tp, tw, SCENARIOS, cfg, device=CPU)
    singles = []
    for sc in SCENARIOS:
        reads = _pass_reads(monkeypatch, teng)
        teng.simulate(tp, tw, _single_cfg(cfg, sc), device=CPU)
        singles.append({i: (total, runs) for i, total, runs in reads})
    monkeypatch.undo()
    assert b.states.n_batches.max() > 1
    partition_reads = merge_repeats = 0
    for i, total, runs in batched:
        rows = [s[i] for s in singles if i in s]
        heads = sum(max([r[p] for _, r in rows if p < len(r)], default=0)
                    for p in range(len(runs)))
        merges = max((t - 1 - sum(r) for t, r in rows), default=0)
        assert total <= 1 + heads + merges, (i, total, rows)
        if not cfg.merge_bursts:
            assert total <= max((t for t, _ in rows), default=1), i
        partition_reads += sum(runs)
        merge_repeats += len(runs) - 1
    if opt in ("partition", "all"):
        assert partition_reads > 0
    if opt in ("merge", "all"):
        assert merge_repeats > 0


@pytest.mark.parametrize("grouped", [False, True], ids=["ledger", "occ"])
def test_one_kernel_call_and_the_same_host_reads_per_iteration_at_any_width(
        monkeypatch, grouped):
    """With every option on and ``fused_kernel=True`` (the wrapper's plain
    version on the CPU) the grid makes one event-wrapper call an iteration,
    and a grid of 8 copies of a scenario makes exactly the host reads of 1
    copy: the partition and merge reads are batched over the rows. That is
    no more than the single run reads (the grid does not attempt a job
    asking for more than a group has unreserved, which the single run
    attempts and reads)."""
    # the ledger kernel is the dense route of a single-group platform
    plat = tplat.curie_platform(36) if grouped else tplat.PlatformSpec(nb_nodes=16)
    wl = tgen.generate_workload(tgen.GeneratorConfig(
        n_jobs=40, nb_res=plat.nb_nodes, max_res=12, mean_interarrival=40.0, seed=1))
    sc = {"scheduler": "EASY PSAS+IPM", "timeout": 120}
    cfg = _single_cfg(EngineConfig(timeout=120, fused_kernel=True, grouped_tables=grouped,
                                   **OPTIONS["all"]), sc)
    name = "event_fuse_occ" if grouped else "event_fuse_ledger"
    calls = []
    real = getattr(event_fuse, name)
    monkeypatch.setattr(event_fuse, name, lambda *a: calls.append(1) or real(*a))
    counts = {}
    for e in (1, 8):
        calls.clear()
        teng.HOST_SYNCS = 0
        b = sweep.sweep(plat, wl, [sc] * e, cfg, device=CPU)
        iters = int(b.states.n_batches.max())
        counts[e] = (len(calls), teng.HOST_SYNCS, iters)
        assert len(calls) == iters
    calls.clear()
    teng.HOST_SYNCS = 0
    single = teng.simulate(plat, wl, cfg, device=CPU)
    assert counts[1] == counts[8]
    assert (counts[8][0], counts[8][2]) == (len(calls), int(single.n_batches))
    assert counts[8][1] <= teng.HOST_SYNCS
    # the partition and merge reads come on top of the loop's two an iteration
    assert counts[8][1] > 2 * counts[8][2]


# --------------------------------------------------------------------------
# the pack key over rows
# --------------------------------------------------------------------------

def _random_rows(seed, plats, j=20):
    """``[E]`` states of ``len(plats)`` rows, each node's state and job
    drawn at random, and the stacked tables of the rows' platforms."""
    rng = np.random.default_rng(seed)
    cfg = EngineConfig(node_order="pack")
    rows, consts = [], []
    for p in plats:
        n = p.nb_nodes
        wl = tgen.generate_workload(tgen.GeneratorConfig(n_jobs=j, nb_res=n, seed=seed))
        d = convert.state_to_arrays(teng.init_state(p, wl, cfg, device=CPU))
        d["node_state"] = rng.choice([IDLE, IDLE, 0, 1, 2, 3, 4], n).astype(np.int32)
        d["node_job"] = np.where(rng.random(n) < 0.4, rng.integers(0, j, n),
                                 -1).astype(np.int32)
        rows.append(convert.state_from_arrays(d, device=CPU))
        consts.append(teng.make_const(p, cfg, device=CPU))
    return rows, consts


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shared", [True, False], ids=["one-platform", "a-platform-a-row"])
def test_pack_key_rows_is_pack_key_of_each_row(seed, shared):
    base = tplat.curie_platform(64)
    plats = [base] * 5 if shared else [base] + [
        tplat.platform_from_groups(tuple(
            dataclasses.replace(g, count=c) for g, c in zip(base.node_groups, counts)))
        for counts in ((40, 12, 12), (2, 2, 60), (30, 30, 4), (21, 21, 22))
    ]
    rows, consts = _random_rows(seed, plats)
    if shared:
        consts = [consts[0]] * len(consts)
    grid = sweep.make_grid(consts, CPU)
    if shared:
        assert grid.const.group_id.stride(0) == 0
    stacked = teng.SimState(*[torch.stack(xs) for xs in zip(*rows)])
    got = tpol.pack_key_rows(stacked, grid.const)
    assert got.dtype == torch.float32 and got.shape == (len(plats), 64)
    for e, (s, c) in enumerate(zip(rows, consts)):
        want = tpol.pack_key(s, c)
        assert torch.equal(got[e], want), e
