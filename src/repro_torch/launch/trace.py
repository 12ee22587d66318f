"""Where the main paths' time goes on the card: profiled windows of the
Curie-scale single runs.

    PYTHONPATH=src python -m repro_torch.launch.trace

Runs the first ``BATCHES`` event batches of each path on the CUDA device:
once to warm up, twice timed without the profiler (the paths in turns,
``dense, grouped, dense_same_inputs`` then the reverse order, so that a
drift of the host's clock shows as a spread rather than as a difference),
and once under ``torch.profiler``. The paths, all EASY PSUS with timeout
1800 s:

* ``dense``: 11 200 homogeneous nodes, the ``cea_curie`` workload cut to
  1000 jobs, the per-node tables (the dense main path);
* ``grouped``: the 3-group ``curie_platform(11200)``, the first 1000 jobs
  of the synthesized Curie SWF trace, the grouped tables (the grouped main
  path);
* ``dense_same_inputs``: the grouped path's platform and jobs on the
  per-node tables, so the two table layouts are compared on equal work.

For each it prints the unprofiled and profiled wall times (their ratio is
the profiler's own host overhead), the summed device kernel time, the
device's busy and idle shares of the mean unprofiled wall time, the
kernels launched per batch, and the top device operations. A window starts at the first batch (the run is capped
with ``max_batches``), so it includes the ramp-up while the first jobs
start. Then it runs two 16-node simulations (dense; grouped with partition
allocation and burst merging, which add reads) with
``torch.cuda.set_sync_debug_mode("warn")`` and compares the number of
synchronizing operations PyTorch reports with the engine's own count
(``engine.HOST_SYNCS``): equal means the loop has no host reads besides the
ones it is built around. Needs a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import warnings

import torch

from repro_torch.core import engine
from repro_torch.core.policy import from_label
from repro_torch.core.types import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.workloads.generator import PRESETS, GeneratorConfig, generate_workload
from repro_torch.workloads.platform import (
    PlatformSpec,
    curie_platform,
    mixed_platform_example,
)
from repro_torch.workloads.traces import replay_workload, synthesize_curie_swf

NODES = 11200
JOBS = 1000
BATCHES = 400


def _capped_run(plat, wl, cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the cap is the point
        s = engine.simulate(plat, wl, cfg, device="cuda")
    torch.cuda.synchronize()
    return s


def main_paths():
    """{name: (platform, workload, config)} of the two Curie-scale main
    paths, capped at ``BATCHES`` batches."""
    base, pol = from_label("EASY PSUS")
    cfg = EngineConfig(base=base, policy=pol, timeout=1800, max_batches=BATCHES)
    dense = generate_workload(
        dataclasses.replace(PRESETS["cea_curie"], n_jobs=JOBS)
    )
    with tempfile.TemporaryDirectory() as tmp:
        swf = synthesize_curie_swf(os.path.join(tmp, "curie.swf"))
        grouped = replay_workload(
            swf, nb_nodes=NODES, oversize="clamp", max_jobs=JOBS
        )
    return {
        "dense": (PlatformSpec(nb_nodes=NODES), dense, cfg),
        "grouped": (curie_platform(NODES), grouped,
                    dataclasses.replace(cfg, grouped_tables=True)),
        "dense_same_inputs": (curie_platform(NODES), grouped, cfg),
    }


def timed_walls(paths) -> dict:
    """{name: [wall s, wall s]}: each path's window timed twice without the
    profiler, the paths in turns (forward, then reverse), after a warm-up
    (allocator, cub scratch, kernel build)."""
    for path in paths.values():
        _capped_run(*path)
    walls = {name: [] for name in paths}
    for name in list(paths) + list(reversed(paths)):
        t0 = time.perf_counter()
        _capped_run(*paths[name])
        walls[name].append(time.perf_counter() - t0)
    return walls


def profile_window(plat, wl, cfg, walls) -> dict:
    """The profiled window of one path, with its unprofiled ``walls``."""
    wall = sum(walls) / len(walls)
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
        "nodes": NODES, "groups": plat.n_groups(), "jobs": len(wl),
        "n_batches": n_batches,
        "wall_s": wall, "walls_s": walls, "profiled_wall_s": profiled_wall,
        "device_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernels_per_batch": len(kernels) / n_batches,
        "top_device_ops": [
            (e.key, e.count, e.self_device_time_total / 1e3) for e in top
        ],
    }


def sync_check(grouped: bool) -> dict:
    """Synchronizing operations PyTorch reports vs the engine's count, on
    the dense path or on the grouped path with partition allocation and
    burst merging."""
    wl = generate_workload(
        GeneratorConfig(n_jobs=100, nb_res=16, seed=0, overrun_prob=0.2)
    )
    base, pol = from_label("EASY PSAS+IPM")
    cfg = EngineConfig(base=base, policy=pol, timeout=300, terminate_overrun=True)
    if grouped:
        plat = mixed_platform_example(16)
        cfg = dataclasses.replace(
            cfg, grouped_tables=True, allocation="partition",
            merge_bursts=True, node_order="cheap",
        )
    else:
        plat = PlatformSpec(nb_nodes=16)
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
    paths = main_paths()
    walls = timed_walls(paths)
    out = {
        "device": torch.cuda.get_device_name(0),
        "windows": {
            name: profile_window(*path, walls[name])
            for name, path in paths.items()
        },
        "syncs": {
            "dense": sync_check(grouped=False),
            "grouped_partition_merge": sync_check(grouped=True),
        },
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
