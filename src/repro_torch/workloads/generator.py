"""Seeded synthetic workload generator (paper §2.3.1: "SPARS includes a
workload generator ... arrival rate, average execution time and variability,
min/max nodes per job, number of jobs").

Presets approximate the published summary statistics of the three traces used
in the paper's illustrative examples (the container is offline, so the real
Parallel Workloads Archive files cannot be fetched; ``parse_swf`` accepts them
when present):

* ``nasa_ipsc``    — NASA Ames iPSC/860: 128 nodes, power-of-two requests.
* ``ciemat_euler`` — CIEMAT Euler: 64 nodes.
* ``cea_curie``    — CEA Curie: 11 200 nodes (large-scale benchmark).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.workloads.workload import Job, Workload


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    n_jobs: int = 200
    nb_res: int = 16
    # inter-arrival: exponential with this mean (seconds)
    mean_interarrival: float = 120.0
    # runtime: lognormal, parameterized by mean and coefficient of variation
    mean_runtime: float = 1800.0
    cv_runtime: float = 1.5
    min_res: int = 1
    max_res: Optional[int] = None  # default nb_res
    power_of_two: bool = False  # request sizes drawn from powers of two
    # requested walltime = runtime * U[1, overreq_factor] (terminate-overrun
    # scenarios instead use reqtime < runtime with prob overrun_prob)
    overreq_factor: float = 3.0
    overrun_prob: float = 0.0
    seed: int = 0


def generate_workload(config: GeneratorConfig = GeneratorConfig(), **kw) -> Workload:
    """Generate a reproducible synthetic workload."""
    if kw:
        config = dataclasses.replace(config, **kw)
    rng = np.random.default_rng(config.seed)
    n = config.n_jobs
    max_res = config.max_res or config.nb_res

    inter = rng.exponential(config.mean_interarrival, size=n)
    subtime = np.floor(np.cumsum(inter)).astype(np.int64)
    subtime[0] = 0

    # lognormal with target mean/cv
    cv2 = config.cv_runtime**2
    sigma2 = np.log1p(cv2)
    mu = np.log(config.mean_runtime) - sigma2 / 2.0
    runtime = np.maximum(
        1, np.round(rng.lognormal(mu, np.sqrt(sigma2), size=n))
    ).astype(np.int64)

    if config.power_of_two:
        max_pow = int(np.log2(max_res))
        min_pow = int(np.ceil(np.log2(max(config.min_res, 1))))
        # favor small jobs (heavy-tailed size distribution, as in NASA trace)
        pows = np.arange(min_pow, max_pow + 1)
        w = 1.0 / (pows - min_pow + 1.0)
        res = 2 ** rng.choice(pows, size=n, p=w / w.sum())
    else:
        lo, hi = config.min_res, max_res
        # discretized truncated geometric-ish: small jobs dominate
        u = rng.uniform(size=n)
        res = np.clip(
            np.round(lo + (hi - lo) * (u**2)), lo, hi
        ).astype(np.int64)

    over = rng.uniform(1.0, config.overreq_factor, size=n)
    reqtime = np.maximum(1, np.round(runtime * over)).astype(np.int64)
    if config.overrun_prob > 0:
        # some users underestimate: requested < actual -> overrun (terminated
        # under the terminate-overrun policy)
        mask = rng.uniform(size=n) < config.overrun_prob
        reqtime[mask] = np.maximum(1, (runtime[mask] * 0.6).astype(np.int64))

    jobs = tuple(
        Job(
            job_id=i,
            res=int(res[i]),
            subtime=int(subtime[i]),
            reqtime=int(reqtime[i]),
            runtime=int(runtime[i]),
            user_id=int(rng.integers(0, 16)),
        )
        for i in range(n)
    )
    return Workload(nb_res=config.nb_res, jobs=jobs).sorted_by_subtime()


PRESETS = {
    # paper Table 3: 128 nodes, last 10 839 jobs (scaled-down default here;
    # benchmarks override n_jobs where the full count matters)
    "nasa_ipsc": GeneratorConfig(
        n_jobs=2000,
        nb_res=128,
        mean_interarrival=540.0,
        mean_runtime=1200.0,
        cv_runtime=2.2,
        power_of_two=True,
        overreq_factor=4.0,
        seed=1860,
    ),
    "ciemat_euler": GeneratorConfig(
        n_jobs=1000,
        nb_res=64,
        mean_interarrival=900.0,
        mean_runtime=3600.0,
        cv_runtime=2.8,
        power_of_two=False,
        overreq_factor=5.0,
        seed=2017,
    ),
    "cea_curie": GeneratorConfig(
        n_jobs=1000,
        nb_res=11200,
        mean_interarrival=300.0,
        mean_runtime=5400.0,
        cv_runtime=3.0,
        min_res=1,
        max_res=8192,
        power_of_two=False,
        overreq_factor=6.0,
        seed=1300,
    ),
    # paper Fig. 3: 200 random jobs on 16 nodes
    "fig3_small": GeneratorConfig(
        n_jobs=200,
        nb_res=16,
        mean_interarrival=60.0,
        mean_runtime=300.0,
        cv_runtime=1.2,
        overreq_factor=2.0,
        overrun_prob=0.15,
        seed=3,
    ),
}


def preset(name: str, **kw) -> Workload:
    cfg = PRESETS[name]
    return generate_workload(cfg, **kw)
