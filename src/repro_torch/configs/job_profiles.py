"""Arch × shape -> HPC job profiles: the loop-closer between the LM
substrate and the simulator — a copy of the reference's
``configs/job_profiles.py`` (its design notes: DESIGN.md §4).

SPARS schedules HPC jobs; the canonical 2025+ HPC job is large-model
training/serving. Each assigned (architecture × input shape) cell becomes a
job profile whose resource request and runtime are DERIVED from the same
numbers the dry-run produces:

    nodes    = chips needed / chips-per-node (v5e: 8 chips/host)
    runtime  = steps x roofline_step_s   (from out/dryrun when present,
               else the analytic 6·N·D / (chips x peak x assumed-MFU))

``profile_workload`` emits a Workload whose jobs are draws over these
profiles — so scheduler/PSM policies are evaluated against a realistic
mix of LM training and serving jobs rather than synthetic lognormals.

Every architecture's numbers come from ``configs.get_arch``, so the workload
is the reference's job for job without running any model.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.shapes import SHAPE_SETS, applicable
from repro_torch.workloads.workload import Job, Workload

# The reference's modelled per-chip bf16 peak (its launch/mesh.py, a TPU
# v5e figure): a constant that DEFINES the profile workload's analytic
# runtimes, so the port draws the same jobs. It is not a figure of the
# card this package runs on.
PEAK_FLOPS_BF16 = 197e12  # FLOP/s

CHIPS_PER_NODE = 8  # v5e host
DEFAULT_CHIPS = 256  # single-pod mesh
ASSUMED_MFU = 0.4


@dataclasses.dataclass(frozen=True)
class JobProfile:
    name: str  # "<arch>:<shape>"
    nodes: int
    runtime_s: int  # one workload unit (e.g. 1000 train steps / a serve shift)
    kind: str


def _param_count(arch: str) -> float:
    # avoids jax.eval_shape cost: analytic count from the config
    cfg = get_arch(arch)
    d, v = cfg.d_model, cfg.padded_vocab
    per_layer = 4 * d * d + 3 * d * max(cfg.d_ff, 1)
    if cfg.n_experts:
        per_layer = 4 * d * d + 3 * d * cfg.expert_d_ff * cfg.n_experts
    return 2 * v * d + cfg.n_layers * per_layer


def _dryrun_step_s(arch: str, shape: str, out_dir: str) -> Optional[float]:
    path = os.path.join(out_dir, f"{arch}__{shape}__single.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return None
    return rec.get("roofline", {}).get("roofline_step_s")


def build_profiles(
    chips: int = DEFAULT_CHIPS,
    steps_per_job: int = 1000,
    out_dir: str = "out/dryrun",
) -> List[JobProfile]:
    profiles = []
    for arch in list_archs():
        cfg = get_arch(arch)
        for shape_name, shape in SHAPE_SETS.items():
            if not applicable(cfg, shape)[0]:
                continue
            step_s = _dryrun_step_s(arch, shape_name, out_dir)
            if step_s is None:
                n = _param_count(arch)
                tokens = shape.batch * shape.seq
                flops = 6.0 * n * tokens if shape.kind == "train" else 2.0 * n * shape.batch
                step_s = flops / (chips * PEAK_FLOPS_BF16 * ASSUMED_MFU)
            runtime = max(60, int(steps_per_job * step_s))
            profiles.append(
                JobProfile(
                    name=f"{arch}:{shape_name}",
                    nodes=chips // CHIPS_PER_NODE,
                    runtime_s=runtime,
                    kind=shape.kind,
                )
            )
    return profiles


def profile_workload(
    n_jobs: int = 200,
    nb_nodes: int = 128,
    mean_interarrival: float = 1200.0,
    seed: int = 0,
    profiles: Optional[Sequence[JobProfile]] = None,
    overreq_factor: float = 1.5,
) -> Workload:
    """Workload whose jobs are (scaled-down) draws over the arch profiles."""
    profs = list(profiles or build_profiles())
    rng = np.random.default_rng(seed)
    inter = rng.exponential(mean_interarrival, size=n_jobs)
    subtime = np.floor(np.cumsum(inter)).astype(np.int64)
    subtime[0] = 0
    jobs = []
    for i in range(n_jobs):
        p = profs[int(rng.integers(0, len(profs)))]
        # scale node request into the platform (profiles assume a full pod)
        res = max(1, min(nb_nodes, int(p.nodes * nb_nodes / 32)))
        runtime = max(60, int(p.runtime_s * rng.lognormal(0.0, 0.3)))
        jobs.append(
            Job(
                job_id=i,
                res=res,
                subtime=int(subtime[i]),
                reqtime=int(runtime * overreq_factor),
                runtime=runtime,
                profile=p.name,
            )
        )
    return Workload(nb_res=nb_nodes, jobs=tuple(jobs)).sorted_by_subtime()
