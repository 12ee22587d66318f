"""Curie-scale SWF trace replay (paper §2.3.1: real archive traces) — a copy
of the JAX reference's numpy-only ``workloads/traces.py``.

:func:`repro_torch.workloads.workload.parse_swf` materializes one ``Job`` per
line as it goes — fine for the paper's small traces, wasteful for
Parallel Workloads Archive files with 10^5..10^6 lines. This module adds
the replay layer the large-scale benchmark needs:

- :func:`iter_swf_chunks` — streaming chunked parse: columnar numpy
  arrays per chunk, never more than ``chunk_jobs`` parsed records live
  (plus one raw line); large-trace consumers can feed the arrays straight
  into ``workload_from_arrays``-style constructors without 10^6 Python
  ``Job`` objects in flight.
- :func:`read_swf` — :func:`parse_swf`-equivalent Workload assembly on
  top of the chunk iterator (both readers share the single cleaning rule
  :func:`repro_torch.workloads.workload.swf_line_job`, so they cannot drift;
  a property test asserts equality on the ragged synthetic fixture).
- :func:`rebase_submit_times` / :func:`map_procs_to_nodes` — the two
  trace-to-simulation adaptations: archive submit times are epoch-like
  offsets (the simulator clock starts at 0), and archive ``procs``
  exceed the simulated node count for oversubscribed traces.
- :func:`replay_workload` — the one-call composition used by
  ``experiments`` specs (``"swf:<path>"``) and ``chip_smoke.py``.
- :func:`synthesize_curie_swf` — deterministic Curie-class SWF writer
  (runs need no download; the real CEA Curie trace drops in via the same
  ``replay_workload`` call when present).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.workloads.workload import (
    Job,
    Workload,
    swf_header_maxprocs,
    swf_line_job,
)

__all__ = [
    "iter_swf_chunks",
    "read_swf",
    "rebase_submit_times",
    "map_procs_to_nodes",
    "replay_workload",
    "write_swf",
    "synthesize_curie_swf",
]

_COLS = ("job_id", "res", "subtime", "reqtime", "runtime")

OVERSIZE_POLICIES = ("clamp", "drop", "error")


def iter_swf_chunks(
    path: str,
    chunk_jobs: int = 8192,
    max_jobs: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream an SWF trace as columnar numpy chunks.

    Yields dicts with i64 arrays ``job_id/res/subtime/reqtime/runtime``
    (≤ ``chunk_jobs`` rows each, trace order). A ``"max_procs"`` key rides
    on the FIRST yielded chunk when the header carried MaxProcs — the
    header precedes all data lines in well-formed SWF, and streaming
    cannot wait for EOF to report it. Dropped/ragged/comment lines are
    skipped by the shared cleaning rule (``swf_line_job``).
    """
    if chunk_jobs <= 0:
        raise ValueError(f"chunk_jobs must be positive, got {chunk_jobs}")
    buf: List[Job] = []
    max_procs: Optional[int] = None
    first = True
    n_seen = 0

    def emit(jobs: List[Job]) -> Dict[str, np.ndarray]:
        nonlocal first
        chunk = {
            "job_id": np.array([j.job_id for j in jobs], np.int64),
            "res": np.array([j.res for j in jobs], np.int64),
            "subtime": np.array([j.subtime for j in jobs], np.int64),
            "reqtime": np.array([j.reqtime for j in jobs], np.int64),
            "runtime": np.array([j.runtime for j in jobs], np.int64),
        }
        if first and max_procs is not None:
            chunk["max_procs"] = max_procs
        first = False
        return chunk

    with open(path) as f:
        for line in f:
            mp = swf_header_maxprocs(line.strip())
            if mp is not None:
                max_procs = mp
                continue
            job = swf_line_job(line)
            if job is None:
                continue
            buf.append(job)
            n_seen += 1
            if len(buf) >= chunk_jobs:
                yield emit(buf)
                buf = []
            if max_jobs is not None and n_seen >= max_jobs:
                break
    if buf or first:
        # the final partial chunk — or an empty first chunk so even a
        # job-less trace reports its MaxProcs header
        yield emit(buf)


def read_swf(
    path: str,
    max_jobs: Optional[int] = None,
    chunk_jobs: int = 8192,
) -> Workload:
    """Streaming :func:`parse_swf` twin: same Workload, chunked parse."""
    cols: Dict[str, List[np.ndarray]] = {c: [] for c in _COLS}
    nb_res = 0
    for chunk in iter_swf_chunks(path, chunk_jobs=chunk_jobs, max_jobs=max_jobs):
        nb_res = int(chunk.get("max_procs", nb_res))
        for c in _COLS:
            cols[c].append(chunk[c])
    arr = {c: np.concatenate(cols[c]) for c in _COLS}
    jobs = tuple(
        Job(
            job_id=int(arr["job_id"][i]),
            res=int(arr["res"][i]),
            subtime=int(arr["subtime"][i]),
            reqtime=int(arr["reqtime"][i]),
            runtime=int(arr["runtime"][i]),
        )
        for i in range(len(arr["job_id"]))
    )
    if nb_res == 0:
        nb_res = max((j.res for j in jobs), default=1)
    return Workload(nb_res=nb_res, jobs=jobs).sorted_by_subtime()


def rebase_submit_times(workload: Workload) -> Workload:
    """Shift submit times so the earliest submission lands at t = 0.

    Archive traces carry epoch-like submit offsets (often starting at
    10^4..10^6 s); the simulator clock starts at 0 and i32 time leaves
    ~2^30 s of headroom, so replay always rebases. Relative spacing —
    including duplicate timestamps — is untouched.
    """
    if not workload.jobs:
        return workload
    t0 = min(j.subtime for j in workload.jobs)
    if t0 == 0:
        return workload
    return Workload(
        workload.nb_res,
        tuple(
            dataclasses.replace(j, subtime=j.subtime - t0)
            for j in workload.jobs
        ),
    )


def map_procs_to_nodes(
    workload: Workload,
    nb_nodes: int,
    procs_per_node: int = 1,
    oversize: str = "clamp",
) -> Workload:
    """Map SWF processor requests onto simulated nodes.

    ``res_nodes = ceil(res / procs_per_node)``; jobs still wider than the
    platform follow the ``oversize`` policy: ``"clamp"`` caps them at
    ``nb_nodes`` (keeps the trace's load, changes its shape), ``"drop"``
    removes them (keeps shapes, loses load), ``"error"`` refuses. The
    returned Workload's ``nb_res`` is ``nb_nodes`` — the engine sizes its
    allocation window from it.
    """
    if oversize not in OVERSIZE_POLICIES:
        raise ValueError(
            f"oversize must be one of {OVERSIZE_POLICIES}, got {oversize!r}"
        )
    if nb_nodes <= 0 or procs_per_node <= 0:
        raise ValueError(
            "nb_nodes and procs_per_node must be positive, got "
            f"{nb_nodes} and {procs_per_node}"
        )
    jobs: List[Job] = []
    for j in workload.jobs:
        res = -(-j.res // procs_per_node)
        if res > nb_nodes:
            if oversize == "drop":
                continue
            if oversize == "error":
                raise ValueError(
                    f"job {j.job_id} needs {res} nodes "
                    f"({j.res} procs / {procs_per_node} per node) on a "
                    f"{nb_nodes}-node platform; pass oversize='clamp' or "
                    "'drop' to replay anyway"
                )
            res = nb_nodes
        jobs.append(dataclasses.replace(j, res=res))
    return Workload(nb_res=nb_nodes, jobs=tuple(jobs))


def replay_workload(
    path: str,
    nb_nodes: Optional[int] = None,
    procs_per_node: int = 1,
    oversize: str = "clamp",
    max_jobs: Optional[int] = None,
    rebase: bool = True,
) -> Workload:
    """Read an SWF trace and adapt it for simulation in one call.

    ``nb_nodes=None`` sizes the platform from the trace itself
    (``ceil(MaxProcs / procs_per_node)``, falling back to the widest job).
    """
    wl = read_swf(path, max_jobs=max_jobs)
    if nb_nodes is None:
        nb_nodes = -(-wl.nb_res // procs_per_node)
    wl = map_procs_to_nodes(
        wl, nb_nodes, procs_per_node=procs_per_node, oversize=oversize
    )
    if rebase:
        wl = rebase_submit_times(wl)
    return wl.sorted_by_subtime()


def write_swf(
    workload: Workload, path: str, max_procs: Optional[int] = None
) -> None:
    """Write a Workload as a Standard Workload Format file.

    Emits the 18 standard fields with ``-1`` for the ones the simulator
    does not model, plus a MaxProcs header — round-trippable through both
    readers.
    """
    mp = int(max_procs if max_procs is not None else workload.nb_res)
    with open(path, "w") as f:
        f.write("; SWF written by repro_torch.workloads.traces.write_swf\n")
        f.write(f"; MaxProcs: {mp}\n")
        for j in workload.sorted_by_subtime().jobs:
            fields = [
                j.job_id, j.subtime, -1, j.runtime, j.res, -1, -1,
                j.res, j.reqtime, -1, 1, j.user_id, -1, -1, -1, -1, -1, -1,
            ]
            f.write(" ".join(str(x) for x in fields) + "\n")


def synthesize_curie_swf(
    path: str, n_jobs: int = 10_000, seed: int = 1300
) -> str:
    """Write a deterministic Curie-class SWF trace and return ``path``.

    So that a run needs no download of ``CEA-Curie-2011-2.1-cln.swf``,
    this synthesizes a trace with
    the ``cea_curie`` generator preset's summary statistics (11 200
    nodes, heavy-tailed runtimes, wide jobs up to 8192 procs) and writes
    it through :func:`write_swf`, exercising the full parse → map →
    rebase replay path end to end. The real trace drops into the same
    ``replay_workload`` call when present.
    """
    from repro_torch.workloads.generator import PRESETS, generate_workload

    wl = generate_workload(PRESETS["cea_curie"], n_jobs=n_jobs, seed=seed)
    write_swf(wl, path, max_procs=wl.nb_res)
    return path
