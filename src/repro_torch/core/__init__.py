"""Engine, policy rules, metrics and the sequential oracle (``core/ref``).

The names below are the reference's ``repro.core`` exports, loaded on first
use: the engine imports the policy layer, which imports ``core/rl``, and
the sweep imports the engine, so an eager import here would be circular.
``repro_torch.core.sweep`` stays the module that holds the batched sweep
(the reference's ``repro.core.sweep`` is the function); the function is
``sweep.sweep``, also reachable as ``engine.sweep`` as in the reference.
"""
import importlib

_EXPORTS = {
    "BasePolicy": "types",
    "EngineConfig": "types",
    "PSMVariant": "types",
    "SimMetrics": "types",
    "PowerPolicy": "policy",
    "AlwaysOn": "policy",
    "TimeoutSleep": "policy",
    "IPM": "policy",
    "PolicyParams": "policy",
    "RLController": "policy",
    "from_label": "policy",
    "label_of": "policy",
    "policy_from_psm": "policy",
    "scheduler_labels": "policy",
    "EngineConst": "engine",
    "SimState": "engine",
    "init_state": "engine",
    "make_const": "engine",
    "next_time": "engine",
    "process_batch": "engine",
    "run_sim": "engine",
    "run_sim_gantt": "engine",
    "simulate": "engine",
    "SimBatch": "sweep",
    "metrics_from_state": "metrics",
    "schedule_table": "metrics",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
