"""Workload & platform modeling (paper §2.3.1) — copies of the reference's
numpy-only ``workloads/platform.py``, ``workload.py`` and ``generator.py``.

The streaming SWF replay (``workloads/traces.py``) is not ported yet.
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
]
