"""Workload model — the paper's ``workload.json`` (§2.3.1, Table 2) + SWF parser.

A workload is a job stream: (job_id, res, subtime, reqtime, runtime, user_id,
profile). ``parse_swf`` reads the Parallel Workloads Archive Standard Workload
Format so real traces (NASA iPSC/860, CIEMAT Euler, CEA Curie) drop in when
available; the container is offline so tests/benchmarks use the seeded
generator presets in :mod:`repro_torch.workloads.generator`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Job:
    job_id: int
    res: int  # requested nodes
    subtime: int  # submission time (s)
    reqtime: int  # requested wall-time (s)
    runtime: int  # realized runtime (s)
    user_id: int = 0
    profile: str = "default"


@dataclasses.dataclass(frozen=True)
class Workload:
    nb_res: int  # max nodes a job may request (paper Table 2)
    jobs: tuple  # tuple[Job]

    def __post_init__(self):
        object.__setattr__(self, "jobs", tuple(self.jobs))

    def __len__(self) -> int:
        return len(self.jobs)

    def sorted_by_subtime(self) -> "Workload":
        return Workload(
            self.nb_res,
            tuple(sorted(self.jobs, key=lambda j: (j.subtime, j.job_id))),
        )

    def tail(self, n: int) -> "Workload":
        """Last ``n`` jobs by submission order (paper uses trace tails)."""
        jobs = sorted(self.jobs, key=lambda j: (j.subtime, j.job_id))[-n:]
        if not jobs:
            return Workload(self.nb_res, ())
        t0 = jobs[0].subtime
        shifted = tuple(
            dataclasses.replace(j, subtime=j.subtime - t0) for j in jobs
        )
        return Workload(self.nb_res, shifted)

    # ---- array views for the JAX engine ----
    def arrays(self) -> Dict[str, np.ndarray]:
        j = self.sorted_by_subtime().jobs
        return {
            "job_id": np.array([x.job_id for x in j], np.int32),
            "res": np.array([x.res for x in j], np.int32),
            "subtime": np.array([x.subtime for x in j], np.int32),
            "reqtime": np.array([x.reqtime for x in j], np.int32),
            "runtime": np.array([x.runtime for x in j], np.int32),
        }

    def to_json(self) -> Dict[str, Any]:
        return {
            "nb_res": self.nb_res,
            "jobs": [
                {
                    "job_id": j.job_id,
                    "res": j.res,
                    "subtime": j.subtime,
                    "user_id": j.user_id,
                    "reqtime": j.reqtime,
                    "runtime": j.runtime,
                    "profile": j.profile,
                }
                for j in self.jobs
            ],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)


def _job_from_json(d: Mapping[str, Any]) -> Job:
    return Job(
        job_id=int(d["job_id"]),
        res=int(d["res"]),
        subtime=int(d["subtime"]),
        reqtime=int(d.get("reqtime", d.get("walltime", d["runtime"]))),
        runtime=int(d["runtime"]),
        user_id=int(d.get("user_id", 0)),
        profile=str(d.get("profile", "default")),
    )


def load_workload(path_or_obj) -> Workload:
    """Load a workload from a JSON file path or a parsed dict."""
    if isinstance(path_or_obj, Mapping):
        obj = path_or_obj
    else:
        with open(path_or_obj) as f:
            obj = json.load(f)
    jobs = tuple(_job_from_json(d) for d in obj["jobs"])
    nb_res = int(obj.get("nb_res", max((j.res for j in jobs), default=1)))
    return Workload(nb_res=nb_res, jobs=jobs).sorted_by_subtime()


def swf_header_maxprocs(line: str) -> Optional[int]:
    """MaxProcs value of an SWF header comment line, if it carries one."""
    if line.startswith(";") and "MaxProcs" in line:
        try:
            return int(line.split(":")[-1])
        except ValueError:
            return None
    return None


def swf_line_job(line: str) -> Optional[Job]:
    """Parse one SWF data line into a :class:`Job`, or None if the line is
    blank, a comment, ragged, or a dropped record.

    SWF fields used: 1 job id, 2 submit time, 4 run time, 5 allocated procs,
    8 requested procs, 9 requested time. Jobs with unknown (-1) runtime or
    zero resources are dropped, matching common SWF-cleaning practice.
    This is the ONE cleaning rule — :func:`parse_swf` and the streaming
    reader (``workloads/traces.py``, ``read_swf``) both go through it, so
    the two readers can never drift.
    """
    line = line.strip()
    if not line or line.startswith(";"):
        return None
    parts = line.split()
    if len(parts) < 9:
        return None
    jid = int(parts[0])
    subtime = int(float(parts[1]))
    runtime = int(float(parts[3]))
    alloc = int(parts[4])
    req_procs = int(parts[7])
    reqtime = int(float(parts[8]))
    res = req_procs if req_procs > 0 else alloc
    if runtime < 0 or res <= 0:
        return None
    if reqtime <= 0:
        reqtime = max(runtime, 1)
    return Job(
        job_id=jid,
        res=res,
        subtime=subtime,
        reqtime=max(reqtime, runtime, 1),
        runtime=max(runtime, 1),
    )


def parse_swf(path: str, max_jobs: Optional[int] = None) -> Workload:
    """Parse a Standard Workload Format trace (Parallel Workloads Archive).

    Cleaning rules live in :func:`swf_line_job`. For Curie-scale traces the
    chunked streaming reader (``workloads/traces.py``, ``read_swf``) parses
    the same format without holding every raw line.
    """
    jobs: List[Job] = []
    nb_res = 0
    with open(path) as f:
        for line in f:
            mp = swf_header_maxprocs(line.strip())
            if mp is not None:
                nb_res = mp
                continue
            job = swf_line_job(line)
            if job is None:
                continue
            jobs.append(job)
            if max_jobs is not None and len(jobs) >= max_jobs:
                break
    if nb_res == 0:
        nb_res = max((j.res for j in jobs), default=1)
    return Workload(nb_res=nb_res, jobs=tuple(jobs)).sorted_by_subtime()


def workload_from_arrays(
    res: Sequence[int],
    subtime: Sequence[int],
    runtime: Sequence[int],
    reqtime: Optional[Sequence[int]] = None,
    nb_res: Optional[int] = None,
) -> Workload:
    n = len(res)
    reqtime = reqtime if reqtime is not None else runtime
    jobs = tuple(
        Job(
            job_id=i,
            res=int(res[i]),
            subtime=int(subtime[i]),
            reqtime=int(reqtime[i]),
            runtime=int(runtime[i]),
        )
        for i in range(n)
    )
    return Workload(
        nb_res=int(nb_res if nb_res is not None else max((j.res for j in jobs), default=1)),
        jobs=jobs,
    ).sorted_by_subtime()
