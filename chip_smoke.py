#!/usr/bin/env python3
"""Drive the PyTorch port of SPARS on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints a line; any failed check exits non-zero):

1. device: the card and its power limit (``nvidia-smi``); no CUDA, no run;
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   source, one ``nvcc``), with the build seconds and each kernel's ptxas
   register, shared-memory and spill lines;
3. kernels: each kernel against its plain PyTorch version on the card,
   bit for bit, at the engine's shapes and more; the device time of each
   (``torch.profiler``: the kernels' own durations), the host time per
   call back to back (CUDA events), and the card's bound for the same work;
4. labels: the paper's seven schedulers on a 16-node homogeneous and a
   16-node mixed platform on the card; then, on the grouped path, the seven
   on a 280-node Curie platform replaying a Curie-class SWF trace, and
   ``node_order="pack"``, ``allocation="partition"`` and ``merge_bursts``
   under EASY PSUS and FCFS PSAS — each held against the port's sequential
   oracle (schedule exact, energy to rel 1e-5);
5. main path, dense: one simulation at CEA-Curie scale (11 200 nodes, the
   ``cea_curie`` workload, 1000 jobs, EASY PSUS, timeout 1800 s) — the
   ledger kernel must have launched once per event batch, and the schedule
   must equal the oracle's; a second run is timed;
6. main path, grouped: the first 1000 jobs of the synthesized Curie SWF
   trace replayed on the 3-group 11 200-node Curie platform, EASY PSUS,
   timeout 1800 s, grouped tables — the occupancy kernel must have launched
   once per event batch, and the schedule must equal the oracle's and a
   dense port run's of the same inputs; a second run is timed;
7. command line: ``python -m repro_torch.launch.sim`` on the card writes
   its outputs.

Then it prints the kernels' JSON line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. It imports
the port (``src/repro_torch``), torch and numpy — nothing of JAX and nothing
of the JAX reference package.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# the event kernels' work is int32 compares and adds outside the tensor
# cores; the closest published scalar peak is the 67 TFLOP/s of float32
SCALAR_OPS_PER_S = 67e12
INF_TIME = 2**30
EXACT_SHAPES = [(1, 16), (1, 131), (13, 131), (1, 11200), (64, 11200)]
ZERO_SHAPES = [(0, 16), (4, 0), (0, 0)]
MAIN_SHAPE = (1, 11200)  # what engine.event_horizon hands the kernels
# (E, N, G) for the occupancy kernel; the main path's is (1, 11200, 3)
OCC_SHAPES = [(1, 16, 1), (13, 131, 3), (1, 11200, 3), (64, 11200, 3),
              (1, 11200, 64)]
OCC_ZERO_SHAPES = [(0, 16, 3), (4, 0, 3), (0, 0, 3)]
# shapes also run with dead lanes: states 7 and group ids -1 and G, which
# the occupancy counts must skip
OCC_DEAD_SHAPES = [(13, 131, 3), (1, 11200, 3)]
OCC_MAIN = (1, 11200, 3)
LABELS = [
    f"{base} {psm}"
    for base in ("FCFS", "EASY")
    for psm in ("PSUS", "PSAS", "PSAS+IPM")
] + ["EASY AlwaysOn"]
GROUPED_OPTIONS = [
    ({"node_order": "pack"}, label) for label in ("EASY PSUS", "FCFS PSAS")
] + [
    ({"node_order": "cheap", "allocation": "partition"}, label)
    for label in ("EASY PSUS", "FCFS PSAS")
] + [
    ({"node_order": "cheap", "merge_bursts": True}, label)
    for label in ("EASY PSUS", "FCFS PSAS")
]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def kernel_inputs(torch, np, e, n, seed=0):
    """States 0..4 with ``until`` straddling ``t``, made from a seed:
    (state, until, t, power) on the card."""
    rng = np.random.default_rng(seed + 1000 * e + n)
    state = rng.integers(0, 5, (e, n)).astype(np.int32)
    t = rng.integers(1000, 50000, (e,)).astype(np.int32)
    until = (t[:, None] + rng.integers(-1000, 1000, (e, n))).astype(np.int32)
    power = np.asarray([9.0, 190.0, 190.0, 190.0, 9.0], np.float32)
    return [torch.from_numpy(x).cuda() for x in (state, until, t, power)]


def occ_inputs(torch, np, e, n, g, seed=0, dead=False):
    """(state, until, t, group_id, G) on the card: the kernel inputs above
    with sorted group ids (contiguous groups, as platforms lay them out).
    With ``dead``, every fifth state is 7 and the first and last group ids
    are -1 and G: nodes that count in no cell."""
    state, until, t, _ = kernel_inputs(torch, np, e, n, seed)
    rng = np.random.default_rng(seed + 7 * n + g)
    gid = np.sort(rng.integers(0, g, n)).astype(np.int32)
    if dead:
        state[:, ::5] = 7
        gid[0], gid[-1] = -1, g
    return [state, until, t, torch.from_numpy(gid).cuda(), g]


def time_ms(torch, fn, args, reps=5, iters=200, warmup=20):
    """Median over ``reps`` of the mean time per call of ``iters`` calls
    back to back between two CUDA events, after a warm-up. A call much
    shorter than its launch measures the host side of the call."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return statistics.median(per_call)


def device_ms(torch, fn, args, calls=200, warmup=20):
    """(device ms per call, device ops per call, op names, share recorded):
    the durations of the device operations that ``calls`` calls launch, read
    from ``torch.profiler``, after a warm-up. Gaps between them and the
    host's time are not counted. The profiler may lose a few records of a
    long capture, so each op name is timed by its mean recorded duration
    times its launches per call (its recorded count over ``calls``,
    rounded); the share of the expected records that were seen is returned
    and must be at least a half."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.device_time_total)
    check(len(by_name) > 0, f"the profiler saw no device operation of {fn.__name__}")
    per_call = {k: max(1, round(len(v) / calls)) for k, v in by_name.items()}
    n_ops = sum(per_call.values())
    seen = sum(len(v) for v in by_name.values()) / (n_ops * calls)
    check(seen >= 0.5, f"the profiler recorded {seen:.2f} of the device "
          f"operations of {fn.__name__}")
    ms = sum(statistics.fmean(v) * per_call[k] for k, v in by_name.items()) / 1e3
    return ms, n_ops, sorted(by_name), seen


def bound_ms(bytes_moved: float, ops: float):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the int32 operations over the scalar peak."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = ops / SCALAR_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "bytes" if by_bytes >= by_ops else "operations"
    )


def ledger_bound(e: int, n: int):
    """event_fuse_ledger at [E, N]: read state and until (4 + 4 bytes a
    node), t and the 5 watts once, write the [E, 8] sums and [E] next once;
    13 int32 operations a node (5 compares, 5 adds, and 2 compares and a
    min for the masked min)."""
    return bound_ms(8 * e * n + 4 * e + 4 * 5 + 4 * 8 * e + 4 * e, 13 * e * n)


def draw_bound(e: int, n: int):
    """event_fuse at [E, N]: as the ledger, with an [E] draw written in
    place of the [E, 8] sums."""
    return bound_ms(8 * e * n + 4 * e + 4 * 5 + 4 * e + 4 * e, 13 * e * n)


def occ_bound(e: int, n: int, g: int):
    """event_fuse_occ at [E, N] and G groups: read state, until (per row)
    and the group ids (once), t once, write the [E, G, 8] counts and [E]
    next once; 10 int32 operations a node (4 range compares, the cell
    index's multiply-add, one count, and 2 compares and a min for the
    masked min)."""
    return bound_ms(8 * e * n + 4 * n + 4 * e + 4 * 8 * g * e + 4 * e,
                    10 * e * n)


def ptxas_report(log: str, kernels):
    """{kernel: [lines]}: the registers, shared-memory and spill lines that
    ``nvcc -Xptxas=-v`` printed for each kernel's entry function."""
    out, cur = {k: [] for k in kernels}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            cur = next((k for k in kernels if f"{k}_kernel" in line), None)
        elif cur and any(w in line for w in ("registers", "spill", "smem")):
            out[cur].append(line.strip())
    return out


def held_against_oracle(metrics, run_pydes, np, plat, wl, cfg, s):
    """Schedule exact and energy to rel 1e-5 against the port's oracle."""
    m_o, des = run_pydes(plat, wl, cfg)
    m = metrics.metrics_from_state(s, plat)
    same = np.array_equal(metrics.schedule_table(s), des.schedule_table())
    rel = abs(m.total_energy_j - m_o.total_energy_j) / max(m_o.total_energy_j, 1.0)
    rel_w = abs(m.wasted_energy_j - m_o.wasted_energy_j) / max(m_o.wasted_energy_j, 1.0)
    return same, max(rel, rel_w), m


def hold_kernel(torch, name, fn, plain, cases, zero_out):
    """Each case's kernel output == its plain version's, bit for bit, with
    one launch per non-empty call; zero sizes give ``zero_out(args)``.
    Returns the max abs difference seen (0.0 when all are equal)."""
    from repro_torch.kernels import event_fuse

    max_err = 0.0
    for label, args, empty in cases:
        before = event_fuse.LAUNCHES[name]
        got = fn(*args)
        torch.cuda.synchronize()
        want = zero_out(args) if empty else plain(*args)
        check(event_fuse.LAUNCHES[name] == before + (0 if empty else 1),
              f"{name} launch count at {label}")
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name} output shape/dtype at {label}")
            check(torch.equal(a, b), f"{name} == plain at {label}")
            if a.numel():
                max_err = max(max_err, float((a.double() - b.double()).abs().max()))
    return max_err


def time_kernel(torch, name, fn, plain, args, bound, shape):
    """(kernel device ms, plain device ms) at ``args``, printed with the
    host times per call, the plain version's device ops and the bound."""
    k_ms, k_ops, k_names, k_seen = device_ms(torch, fn, args)
    p_ms, p_ops, _, p_seen = device_ms(torch, plain, args)
    check(k_ops == 1 and all(f"{name}_kernel" in x for x in k_names),
          f"{name} ran {k_ops} device ops a call: {k_names}")
    k_host = time_ms(torch, fn, args)
    p_host = time_ms(torch, plain, args)
    b_ms, b_by = bound
    print(f"phase 3 kernels: {name} {shape}: "
          f"device time kernel {1e3 * k_ms:.3f} us, plain {1e3 * p_ms:.3f} us "
          f"({p_ops} device ops; profiler records seen: kernel "
          f"{k_seen:.3f}, plain {p_seen:.3f}); bound {1e3 * b_ms:.4f} us ({b_by}); "
          f"host time per call back to back: kernel wrapper "
          f"{1e3 * k_host:.2f} us, plain {1e3 * p_host:.2f} us; no single "
          "PyTorch call computes this fused pair, so there is no library "
          "time", flush=True)
    return k_ms, p_ms


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — nothing was run")
    import numpy as np

    from repro_torch.core import engine, metrics
    from repro_torch.core.policy import from_label
    from repro_torch.core.ref.pydes import run_pydes
    from repro_torch.core.types import EngineConfig
    from repro_torch.kernels import _build, event_fuse
    from repro_torch.workloads.generator import (
        PRESETS, GeneratorConfig, generate_workload,
    )
    from repro_torch.workloads.platform import (
        PlatformSpec, curie_platform, mixed_platform_example,
    )
    from repro_torch.workloads.traces import replay_workload, synthesize_curie_swf

    t_script = time.perf_counter()
    # ---- 1. device ----
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name}, count={torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}; "
          f"nvidia-smi: {smi}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.load("event_fuse")
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: event_fuse.cu with {', '.join(event_fuse.KERNELS)} "
          f"(wall {build_s:.1f} s)", flush=True)
    report = ptxas_report(_build.build_log("event_fuse"), event_fuse.KERNELS)
    for kname in event_fuse.KERNELS:
        check(report[kname], f"ptxas reported nothing for {kname}")
        for line in report[kname]:
            print(f"  ptxas {kname}: {line}")

    # ---- 3. kernels against their plain versions ----
    def empty_pair(cols):
        def zero_out(args):
            e = args[0].shape[0]
            return (torch.zeros((e, *cols(args)), device="cuda"),
                    torch.full((e,), INF_TIME, dtype=torch.int32, device="cuda"))
        return zero_out

    err = {}
    err["event_fuse_ledger"] = hold_kernel(
        torch, "event_fuse_ledger", event_fuse.event_fuse_ledger,
        event_fuse.event_fuse_ledger_plain,
        [((e, n), kernel_inputs(torch, np, e, n), not (e and n))
         for e, n in EXACT_SHAPES + ZERO_SHAPES],
        empty_pair(lambda args: (8,)),
    )
    err["event_fuse_occ"] = hold_kernel(
        torch, "event_fuse_occ", event_fuse.event_fuse_occ,
        event_fuse.event_fuse_occ_plain,
        [((e, n, g), occ_inputs(torch, np, e, n, g), not (e and n))
         for e, n, g in OCC_SHAPES + OCC_ZERO_SHAPES]
        + [((e, n, g, "dead lanes"), occ_inputs(torch, np, e, n, g, dead=True),
            False) for e, n, g in OCC_DEAD_SHAPES],
        empty_pair(lambda args: (args[4], 8)),
    )
    err["event_fuse"] = hold_kernel(
        torch, "event_fuse", event_fuse.event_fuse, event_fuse.event_fuse_plain,
        [((e, n), kernel_inputs(torch, np, e, n), not (e and n))
         for e, n in EXACT_SHAPES + ZERO_SHAPES],
        empty_pair(lambda args: ()),
    )
    timing = {}
    for e, n in (MAIN_SHAPE, (64, 11200)):
        timing["event_fuse_ledger", e] = time_kernel(
            torch, "event_fuse_ledger", event_fuse.event_fuse_ledger,
            event_fuse.event_fuse_ledger_plain, kernel_inputs(torch, np, e, n),
            ledger_bound(e, n), f"E={e} N={n}")
    for e, n, g in (OCC_MAIN, (64, 11200, 3)):
        timing["event_fuse_occ", e] = time_kernel(
            torch, "event_fuse_occ", event_fuse.event_fuse_occ,
            event_fuse.event_fuse_occ_plain, occ_inputs(torch, np, e, n, g),
            occ_bound(e, n, g), f"E={e} N={n} G={g}")
    timing["event_fuse", 1] = time_kernel(
        torch, "event_fuse", event_fuse.event_fuse, event_fuse.event_fuse_plain,
        kernel_inputs(torch, np, *MAIN_SHAPE), draw_bound(*MAIN_SHAPE),
        "E={} N={}".format(*MAIN_SHAPE))
    print(f"phase 3 kernels: each kernel == its plain version bit for bit: "
          f"event_fuse_ledger and event_fuse at {EXACT_SHAPES}, "
          f"event_fuse_occ at (E, N, G) {OCC_SHAPES}, with dead lanes at "
          f"{OCC_DEAD_SHAPES}, and zero sizes; "
          f"max_abs_err {err}", flush=True)

    # ---- 4. the paper's schedulers on the card ----
    t0 = time.perf_counter()
    n_label_runs = 0
    for plat, order in ((PlatformSpec(nb_nodes=16), "id"),
                        (mixed_platform_example(16), "cheap")):
        wl = generate_workload(
            GeneratorConfig(n_jobs=100, nb_res=16, seed=0, overrun_prob=0.2)
        )
        for label in LABELS:
            base, pol = from_label(label)
            cfg = EngineConfig(base=base, policy=pol, timeout=300,
                               terminate_overrun=True, node_order=order)
            s = engine.simulate(plat, wl, cfg, device="cuda")
            same, rel, _ = held_against_oracle(
                metrics, run_pydes, np, plat, wl, cfg, s)
            check(same, f"{label} on {order}-ordered platform: schedule")
            check(rel <= 1e-5, f"{label}: energy rel err {rel}")
            n_label_runs += 1
    print(f"phase 4 labels: {n_label_runs} runs on cuda == oracle "
          f"(schedule exact, energy rel <= 1e-5) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    swf = synthesize_curie_swf(os.path.join(tmp, "curie.swf"))  # seed 1300
    t0 = time.perf_counter()
    plat = curie_platform(280)
    wl = replay_workload(swf, nb_nodes=280, oversize="clamp", max_jobs=120)
    grouped_runs = [({"node_order": "cheap"}, label) for label in LABELS]
    worst = 0.0
    for opts, label in grouped_runs + GROUPED_OPTIONS:
        base, pol = from_label(label)
        cfg = EngineConfig(base=base, policy=pol, timeout=1800,
                           grouped_tables=True, **opts)
        event_fuse.reset_launches()
        s = engine.simulate(plat, wl, cfg, device="cuda")
        check(event_fuse.LAUNCHES["event_fuse_occ"] == int(s.n_batches),
              f"grouped {label} {opts}: occupancy kernel launches")
        same, rel, _ = held_against_oracle(
            metrics, run_pydes, np, plat, wl, cfg, s)
        check(same, f"grouped {label} {opts}: schedule")
        check(rel <= 1e-5, f"grouped {label} {opts}: energy rel err {rel}")
        worst = max(worst, rel)
    print(f"phase 4 grouped: {len(grouped_runs)} labels and "
          f"{len(GROUPED_OPTIONS)} pack/partition/merge_bursts runs on "
          f"curie_platform(280), {len(wl)} replayed jobs, on cuda == oracle "
          f"(schedule exact, energy rel err <= {worst:.2e}), occupancy kernel "
          f"launches == n_batches, in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- 5. the main path at CEA-Curie scale, dense ----
    gcfg = dataclasses.replace(PRESETS["cea_curie"], n_jobs=1000)
    wl = generate_workload(gcfg)
    plat = PlatformSpec(nb_nodes=11200)
    base, pol = from_label("EASY PSUS")
    cfg = EngineConfig(base=base, policy=pol, timeout=1800)
    event_fuse.reset_launches()
    engine.HOST_SYNCS = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = engine.simulate(plat, wl, cfg, device="cuda")
    first_s = time.perf_counter() - t0
    launches = dict(event_fuse.LAUNCHES)
    syncs = engine.HOST_SYNCS
    n_batches = int(s.n_batches)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    check(n_batches > 0, "main path ran no batch")
    check(launches["event_fuse_ledger"] == n_batches,
          f"ledger kernel launches {launches} != n_batches {n_batches}")
    check(launches["event_fuse_occ"] == 0, "dense path launched the occ kernel")
    check(launches["event_fuse"] == 0, "dense path launched event_fuse")
    draw_launches = launches["event_fuse"]
    check(not bool(s.truncated), "main path hit its batch cap")
    t0 = time.perf_counter()
    same, rel, m = held_against_oracle(
        metrics, run_pydes, np, plat, wl, cfg, s)
    oracle_s = time.perf_counter() - t0
    check(same, "main path schedule == oracle")
    check(rel <= 1e-5, f"main path energy rel err {rel}")
    t0 = time.perf_counter()
    s2 = engine.simulate(plat, wl, cfg, device="cuda")
    wall_s = time.perf_counter() - t0
    check(metrics.np_state(s2)["job_start"].tolist()
          == metrics.np_state(s)["job_start"].tolist(), "rerun schedule")
    dense_launches = launches["event_fuse_ledger"]
    print(f"phase 5 main path: {plat.nb_nodes} nodes, cea_curie {len(wl)} jobs, EASY "
          f"PSUS timeout 1800 on cuda: n_batches {n_batches}, kernel "
          f"launches {dense_launches}, host syncs {syncs} "
          f"({syncs / n_batches:.3f}/batch), schedule == oracle, energy rel "
          f"err {rel:.2e}, makespan {m.makespan_s} s, total "
          f"{m.total_energy_j / 3.6e6:.1f} kWh; wall first run {first_s:.2f} "
          f"s, second run {wall_s:.2f} s = "
          f"{1e6 * wall_s / n_batches:.1f} us/batch; oracle {oracle_s:.2f} "
          f"s; peak device memory {peak_mib:.1f} MiB", flush=True)

    # ---- 6. the main path at CEA-Curie scale, grouped ----
    plat = curie_platform(11200)
    wl = replay_workload(swf, nb_nodes=11200, oversize="clamp", max_jobs=1000)
    cfg = EngineConfig(base=base, policy=pol, timeout=1800, grouped_tables=True)
    event_fuse.reset_launches()
    engine.HOST_SYNCS = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = engine.simulate(plat, wl, cfg, device="cuda")
    g_first_s = time.perf_counter() - t0
    launches = dict(event_fuse.LAUNCHES)
    g_syncs = engine.HOST_SYNCS
    g_batches = int(s.n_batches)
    g_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    check(g_batches > 0, "grouped main path ran no batch")
    check(launches["event_fuse_occ"] == g_batches,
          f"occ kernel launches {launches} != n_batches {g_batches}")
    check(launches["event_fuse_ledger"] == 0,
          "grouped path launched the ledger kernel")
    check(launches["event_fuse"] == 0, "grouped path launched event_fuse")
    draw_launches += launches["event_fuse"]
    check(not bool(s.truncated), "grouped main path hit its batch cap")
    occ_launches = launches["event_fuse_occ"]
    t0 = time.perf_counter()
    s_dense = engine.simulate(
        plat, wl, dataclasses.replace(cfg, grouped_tables=False), device="cuda")
    dense_s = time.perf_counter() - t0
    check(np.array_equal(metrics.schedule_table(s),
                         metrics.schedule_table(s_dense)),
          "grouped schedule == dense port run's")
    d_g, d_d = metrics.np_state(s), metrics.np_state(s_dense)
    for fld in ("t", "n_batches", "node_state", "job_finish", "n_switch_on",
                "n_switch_off"):
        check(np.array_equal(d_g[fld], d_d[fld]), f"grouped {fld} == dense")
    e_rel = float(np.max(np.abs(d_g["energy"] - d_d["energy"])
                         / np.maximum(np.abs(d_d["energy"]), 1e-30)))
    check(np.allclose(d_g["energy"], d_d["energy"], rtol=1e-6, atol=0.0),
          f"grouped energy == dense to rtol 1e-6 (max rel {e_rel:.2e})")
    t0 = time.perf_counter()
    same, rel, m = held_against_oracle(
        metrics, run_pydes, np, plat, wl, cfg, s)
    g_oracle_s = time.perf_counter() - t0
    check(same, "grouped main path schedule == oracle")
    check(rel <= 1e-5, f"grouped main path energy rel err {rel}")
    t0 = time.perf_counter()
    s2 = engine.simulate(plat, wl, cfg, device="cuda")
    g_wall_s = time.perf_counter() - t0
    check(np.array_equal(metrics.schedule_table(s2), metrics.schedule_table(s)),
          "grouped rerun schedule")
    print(f"phase 6 grouped main path: curie_platform({plat.nb_nodes}) "
          f"(G={plat.n_groups()}), {len(wl)} jobs replayed from the synthesized "
          f"Curie SWF, EASY PSUS timeout 1800, grouped tables, on cuda: "
          f"n_batches {g_batches}, occ kernel launches {occ_launches}, host "
          f"syncs {g_syncs} ({g_syncs / g_batches:.3f}/batch), schedule == "
          f"oracle (energy rel err {rel:.2e}) == dense port run (energy max "
          f"rel diff {e_rel:.2e}), makespan {m.makespan_s} s, total "
          f"{m.total_energy_j / 3.6e6:.1f} kWh; wall first run {g_first_s:.2f} "
          f"s, second run {g_wall_s:.2f} s = {1e6 * g_wall_s / g_batches:.1f} "
          f"us/batch; dense port run of the same inputs {dense_s:.2f} s = "
          f"{1e6 * dense_s / int(s_dense.n_batches):.1f} us/batch; oracle "
          f"{g_oracle_s:.2f} s; peak device memory {g_peak_mib:.1f} MiB",
          flush=True)

    # ---- 7. the command line on the card ----
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "repro_torch.launch.sim",
               "--workload", "preset:fig3_small", "--platform", "16",
               "--scheduler", "EASY PSUS", "--timeout", "900", "--out", out]
        env = dict(os.environ, PYTHONPATH=SRC)
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        check(res.returncode == 0, f"driver failed:\n{res.stderr[-4000:]}")
        wrote = sorted(os.listdir(out))
        try:
            import matplotlib  # noqa: F401  (the driver draws the PNG with it)
            want = ["gantt.csv", "gantt.png", "jobs.csv", "metrics.json"]
        except ImportError:
            want = ["gantt.csv", "jobs.csv", "metrics.json"]
        check(wrote == want, f"driver outputs {wrote}, expected {want}")
        with open(os.path.join(out, "metrics.json")) as f:
            row = json.load(f)
        check(row["n_jobs"] == 200 and row["makespan_s"] > 0,
              "driver metrics")
    print(f"phase 7 command line: python -m repro_torch.launch.sim wrote "
          f"{wrote} in {time.perf_counter() - t0:.1f} s", flush=True)

    def entry(kname, replaces, launches, key, bound, note=None):
        k_ms, p_ms = timing[key]
        b_ms, b_by = bound
        row = {
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/event_fuse.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err[kname], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        }
        if note:
            row["note"] = note
        return row

    print(json.dumps({"kernels": [
        entry("event_fuse_ledger", "src/repro/kernels/event_fuse.py:74",
              dense_launches, ("event_fuse_ledger", 1), ledger_bound(*MAIN_SHAPE)),
        entry("event_fuse_occ", "src/repro/kernels/event_fuse.py:113",
              occ_launches, ("event_fuse_occ", 1), occ_bound(*OCC_MAIN)),
        entry("event_fuse", "src/repro/kernels/event_fuse.py:47", draw_launches,
              ("event_fuse", 1), draw_bound(*MAIN_SHAPE),
              note="no engine path calls it; timed at [1, 11200]"),
    ]}))
    print(f"script wall {time.perf_counter() - t_script:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
