#!/usr/bin/env python3
"""Drive the PyTorch port of SPARS on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints a line; any failed check exits non-zero):

1. device: the card and its power limit (``nvidia-smi``); no CUDA, no run;
2. build: the CUDA kernel from ``src/repro_torch/kernels/csrc``, with the
   build seconds;
3. kernels: each kernel against its plain PyTorch version on the card,
   bit for bit, at the engine's shapes and more; the device time of each
   (``torch.profiler``: the kernels' own durations), the host time per
   call back to back (CUDA events), and the card's bound for the same work;
4. labels: the paper's seven schedulers on a 16-node homogeneous and a
   16-node mixed platform on the card, held against the port's sequential
   oracle (schedule exact, energy to rel 1e-5);
5. main path: one simulation at CEA-Curie scale (11 200 nodes, the
   ``cea_curie`` workload, 1000 jobs, EASY PSUS, timeout 1800 s) — the
   event kernel must have launched once per event batch, and the schedule
   must equal the oracle's; a second run is timed;
6. driver: ``python -m repro_torch.launch.sim`` on the card writes its
   outputs.

Then it prints the kernels' JSON line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. It imports
the port (``src/repro_torch``), torch and numpy — nothing of JAX and nothing
of the JAX reference package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# the event kernel's work is int32 compares and adds outside the tensor
# cores; the closest published scalar peak is the 67 TFLOP/s of float32
SCALAR_OPS_PER_S = 67e12
EXACT_SHAPES = [(1, 16), (1, 131), (13, 131), (1, 11200), (64, 11200)]
ZERO_SHAPES = [(0, 16), (4, 0), (0, 0)]
MAIN_SHAPE = (1, 11200)  # what engine.event_horizon hands the kernel
LABELS = [
    f"{base} {psm}"
    for base in ("FCFS", "EASY")
    for psm in ("PSUS", "PSAS", "PSAS+IPM")
] + ["EASY AlwaysOn"]


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
    """States 0..4 with ``until`` straddling ``t``, made from a seed."""
    rng = np.random.default_rng(seed + 1000 * e + n)
    state = rng.integers(0, 5, (e, n)).astype(np.int32)
    t = rng.integers(1000, 50000, (e,)).astype(np.int32)
    until = (t[:, None] + rng.integers(-1000, 1000, (e, n))).astype(np.int32)
    power = np.asarray([9.0, 190.0, 190.0, 190.0, 9.0], np.float32)
    return [torch.from_numpy(x).cuda() for x in (state, until, t, power)]


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
    """(device ms per call, device ops per call, op names): the summed
    durations of the device operations that ``calls`` calls launch, read
    from ``torch.profiler``, after a warm-up. Gaps between them and the
    host's time are not counted."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(ops) > 0, f"the profiler saw no device operation of {fn.__name__}")
    return (sum(e.device_time_total for e in ops) / 1e3 / calls,
            len(ops) / calls, sorted({e.name for e in ops}))


def bound_ms(e: int, n: int):
    """(ms, "bytes" or "operations"): the least time the card could take for
    event_fuse_ledger at [E, N] — read state and until (4 + 4 bytes a
    node), t and the 5 watts once, write the [E, 8] sums and [E] next once;
    13 int32 operations a node (5 compares, 5 adds, and 2 compares and a
    min for the masked min)."""
    bytes_moved = 8 * e * n + 4 * e + 4 * 5 + 4 * 8 * e + 4 * e
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = 13 * e * n / SCALAR_OPS_PER_S
    return 1e3 * max(by_bytes, by_ops), (
        "bytes" if by_bytes >= by_ops else "operations"
    )


def held_against_oracle(metrics, run_pydes, np, plat, wl, cfg, s):
    """Schedule exact and energy to rel 1e-5 against the port's oracle."""
    m_o, des = run_pydes(plat, wl, cfg)
    m = metrics.metrics_from_state(s, plat)
    same = np.array_equal(metrics.schedule_table(s), des.schedule_table())
    rel = abs(m.total_energy_j - m_o.total_energy_j) / max(m_o.total_energy_j, 1.0)
    rel_w = abs(m.wasted_energy_j - m_o.wasted_energy_j) / max(m_o.wasted_energy_j, 1.0)
    return same, max(rel, rel_w), m


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
    from repro_torch.workloads.platform import PlatformSpec, mixed_platform_example

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
    print(f"phase 2 build: event_fuse (wall {build_s:.1f} s)", flush=True)
    for line in _build.build_log("event_fuse").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas event_fuse: {line.strip()}")

    # ---- 3. kernels against their plain versions ----
    max_err = 0.0
    for e, n in EXACT_SHAPES + ZERO_SHAPES:
        args = kernel_inputs(torch, np, e, n)
        before = event_fuse.LAUNCHES
        got = event_fuse.event_fuse_ledger(*args)
        torch.cuda.synchronize()
        want = event_fuse.event_fuse_ledger_plain(*args) if e and n else (
            torch.zeros((e, 8), device="cuda"),
            torch.full((e,), 2**30, dtype=torch.int32, device="cuda"),
        )
        check(event_fuse.LAUNCHES == before + (1 if e and n else 0),
              f"event_fuse_ledger launch count at {(e, n)}")
        for a, b in zip(got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"event_fuse_ledger output shape/dtype at {(e, n)}")
            check(torch.equal(a, b), f"event_fuse_ledger == plain at {(e, n)}")
            if a.numel():
                max_err = max(max_err, float((a.double() - b.double()).abs().max()))
    timing = {}
    for e, n in (MAIN_SHAPE, (64, 11200)):
        args = kernel_inputs(torch, np, e, n)
        k_ms, k_ops, k_names = device_ms(torch, event_fuse.event_fuse_ledger, args)
        p_ms, p_ops, _ = device_ms(torch, event_fuse.event_fuse_ledger_plain, args)
        check(k_ops == 1 and all("event_fuse_ledger_kernel" in x for x in k_names),
              f"event_fuse_ledger ran {k_ops} device ops a call: {k_names}")
        b_ms, b_by = bound_ms(e, n)
        k_host = time_ms(torch, event_fuse.event_fuse_ledger, args)
        p_host = time_ms(torch, event_fuse.event_fuse_ledger_plain, args)
        timing[(e, n)] = (k_ms, p_ms, b_ms, b_by)
        print(f"phase 3 kernels: event_fuse_ledger E={e} N={n}: device time "
              f"kernel {1e3 * k_ms:.3f} us, plain {1e3 * p_ms:.3f} us "
              f"({p_ops:.0f} device ops); bound {1e3 * b_ms:.4f} us ({b_by}); "
              f"host time per call back to back: kernel wrapper "
              f"{1e3 * k_host:.2f} us, plain {1e3 * p_host:.2f} us; no single "
              "PyTorch call computes this fused pair, so there is no library "
              "time", flush=True)
    print(f"phase 3 kernels: event_fuse_ledger == plain bit for bit at "
          f"{EXACT_SHAPES} and zero sizes {ZERO_SHAPES}, max_abs_err "
          f"{max_err}", flush=True)

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

    # ---- 5. the main path at CEA-Curie scale ----
    gcfg = dataclasses.replace(PRESETS["cea_curie"], n_jobs=1000)
    wl = generate_workload(gcfg)
    plat = PlatformSpec(nb_nodes=11200)
    base, pol = from_label("EASY PSUS")
    cfg = EngineConfig(base=base, policy=pol, timeout=1800)
    event_fuse.LAUNCHES = 0
    engine.HOST_SYNCS = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = engine.simulate(plat, wl, cfg, device="cuda")
    first_s = time.perf_counter() - t0
    launches = event_fuse.LAUNCHES
    syncs = engine.HOST_SYNCS
    n_batches = int(s.n_batches)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    check(n_batches > 0, "main path ran no batch")
    check(launches == n_batches,
          f"event kernel launches {launches} != n_batches {n_batches}")
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
    print(f"phase 5 main path: {plat.nb_nodes} nodes, cea_curie {len(wl)} jobs, EASY "
          f"PSUS timeout 1800 on cuda: n_batches {n_batches}, kernel "
          f"launches {launches}, host syncs {syncs} "
          f"({syncs / n_batches:.3f}/batch), schedule == oracle, energy rel "
          f"err {rel:.2e}, makespan {m.makespan_s} s, total "
          f"{m.total_energy_j / 3.6e6:.1f} kWh; wall first run {first_s:.2f} "
          f"s, second run {wall_s:.2f} s = "
          f"{1e6 * wall_s / n_batches:.1f} us/batch; oracle {oracle_s:.2f} "
          f"s; peak device memory {peak_mib:.1f} MiB", flush=True)

    # ---- 6. the driver on the card ----
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
    print(f"phase 6 driver: python -m repro_torch.launch.sim wrote {wrote} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    k_ms, p_ms, b_ms, b_by = timing[MAIN_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "event_fuse_ledger",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_fuse.cu",
        "replaces": "src/repro/kernels/event_fuse.py:74",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]}))
    print(f"script wall {time.perf_counter() - t_script:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
