"""Declarative run specs (the single-run resolvers of ``spec.py``)."""
from repro_torch.experiments.spec import (
    check_unknown_keys,
    check_workload_keys,
    resolve_platform,
    resolve_workload,
)

__all__ = [
    "check_unknown_keys",
    "check_workload_keys",
    "resolve_platform",
    "resolve_workload",
]
