"""Workload & platform modeling (paper §2.3.1) — copies of the reference's
numpy-only ``workloads/platform.py``, ``workload.py``, ``generator.py`` and
``traces.py`` (the streaming SWF replay).
"""
from repro_torch.workloads.platform import (
    PlatformSpec,
    DEFAULT_PLATFORM,
    curie_platform,
    load_platform,
    make_platform,
)
from repro_torch.workloads.workload import Job, Workload, load_workload, parse_swf
from repro_torch.workloads.generator import generate_workload, PRESETS
from repro_torch.workloads.traces import (
    iter_swf_chunks,
    map_procs_to_nodes,
    read_swf,
    rebase_submit_times,
    replay_workload,
    synthesize_curie_swf,
    write_swf,
)

__all__ = [
    "PlatformSpec",
    "DEFAULT_PLATFORM",
    "curie_platform",
    "load_platform",
    "make_platform",
    "Job",
    "Workload",
    "load_workload",
    "parse_swf",
    "generate_workload",
    "PRESETS",
    "iter_swf_chunks",
    "read_swf",
    "rebase_submit_times",
    "map_procs_to_nodes",
    "replay_workload",
    "write_swf",
    "synthesize_curie_swf",
]
