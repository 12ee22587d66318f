"""Where the main path's time goes on the card: a profiled window of the
Curie-scale single run.

    PYTHONPATH=src python -m repro_torch.launch.trace

Runs the first ``BATCHES`` event batches of the main path (11 200 nodes,
the ``cea_curie`` workload cut to 1000 jobs, EASY PSUS, timeout 1800 s) on
the CUDA device three times: to warm up, timed without the profiler, and
under ``torch.profiler``. It prints both wall times (their ratio is the
profiler's own host overhead), the summed device kernel time, the device's
busy and idle shares of the unprofiled wall time, the kernels launched per
batch, and the top device operations. The window starts at the first batch
(the run is capped with ``max_batches``), so it includes the ramp-up while
the first jobs start. Then it
runs a 16-node simulation with ``torch.cuda.set_sync_debug_mode("warn")``
and compares the number of synchronizing operations PyTorch reports with
the engine's own count (``engine.HOST_SYNCS``): equal means the loop has
no host reads besides the ones it is built around. Needs a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings

import torch

from repro_torch.core import engine
from repro_torch.core.policy import from_label
from repro_torch.core.types import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.workloads.generator import PRESETS, GeneratorConfig, generate_workload
from repro_torch.workloads.platform import PlatformSpec

NODES = 11200
JOBS = 1000
BATCHES = 400


def _capped_run(plat, wl, cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the cap is the point
        s = engine.simulate(plat, wl, cfg, device="cuda")
    torch.cuda.synchronize()
    return s


def profile_window() -> dict:
    plat = PlatformSpec(nb_nodes=NODES)
    wl = generate_workload(dataclasses.replace(PRESETS["cea_curie"], n_jobs=JOBS))
    base, pol = from_label("EASY PSUS")
    cfg = EngineConfig(base=base, policy=pol, timeout=1800, max_batches=BATCHES)
    _capped_run(plat, wl, cfg)  # warm-up: allocator, cub scratch, kernel build
    t0 = time.perf_counter()
    _capped_run(plat, wl, cfg)
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        s = _capped_run(plat, wl, cfg)
        profiled_wall = time.perf_counter() - t0
    n_batches = int(s.n_batches)
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_us = sum(e.device_time_total for e in kernels)
    top = sorted(
        prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True
    )[:10]
    return {
        "nodes": NODES, "jobs": JOBS, "n_batches": n_batches,
        "wall_s": wall, "profiled_wall_s": profiled_wall,
        "device_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernels_per_batch": len(kernels) / n_batches,
        "top_device_ops": [
            (e.key, e.count, e.self_device_time_total / 1e3) for e in top
        ],
    }


def sync_check() -> dict:
    """Synchronizing operations PyTorch reports vs the engine's count."""
    plat = PlatformSpec(nb_nodes=16)
    wl = generate_workload(
        GeneratorConfig(n_jobs=100, nb_res=16, seed=0, overrun_prob=0.2)
    )
    base, pol = from_label("EASY PSAS+IPM")
    cfg = EngineConfig(base=base, policy=pol, timeout=300, terminate_overrun=True)
    engine.simulate(plat, wl, cfg, device="cuda")  # warm-up
    # the loop only: building the state copies from the host, which
    # PyTorch also reports
    cfg = engine.trim_window(cfg, len(wl))
    s0 = engine.init_state(plat, wl, cfg, device="cuda")
    const = engine.make_const(plat, cfg, device="cuda")
    torch.cuda.synchronize()
    engine.HOST_SYNCS = 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            s = engine.run_sim(s0, const, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reported = [str(r.message) for r in rec if "synchroniz" in str(r.message)]
    return {
        "n_batches": int(s.n_batches),
        "engine_host_syncs": engine.HOST_SYNCS,
        "pytorch_reported_syncs": len(reported),
    }


def main():
    resolve_device()  # raises without a card
    out = {
        "device": torch.cuda.get_device_name(0),
        "window": profile_window(),
        "syncs": sync_check(),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
