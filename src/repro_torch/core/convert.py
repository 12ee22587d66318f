"""Carry a simulation across engines: the reference's state and tables in
numpy form to the port's tensors, and back.

The dict keys are the field names of the reference's ``SimState`` and
``EngineConst`` (identical in the port), so a state taken from the JAX
engine with ``repro.core.metrics.np_state`` continues in the PyTorch engine,
and a port state comes back as numpy arrays of the same names and dtypes.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from repro_torch.core.engine import EngineConst, SimState
from repro_torch.core.policy import PolicyParams
from repro_torch.core.tables import GroupTables
from repro_torch.device import DeviceLike, resolve_device


def _tensor(key: str, value, device: torch.device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype not in (np.int32, np.float32, np.bool_):
        raise TypeError(
            f"{key}: expected an int32, float32 or bool array, got {arr.dtype}"
        )
    # a writable C-order copy (keeps 0-d arrays 0-d, unlike ascontiguousarray)
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(device)


def _require(d: Mapping, fields) -> None:
    missing = [k for k in fields if k not in d]
    if missing:
        raise KeyError(f"missing field(s): {', '.join(missing)}")


def state_from_arrays(
    d: Mapping[str, np.ndarray], device: DeviceLike = None
) -> SimState:
    """A :class:`SimState` on ``device`` from numpy arrays keyed by field.
    Stacked arrays (the reference's ``SimBatch.states``, a leading scenario
    axis on every field) give the batched ``[E]`` state of
    ``core/sweep.py``."""
    dev = resolve_device(device)
    _require(d, SimState._fields)
    return SimState(**{k: _tensor(k, d[k], dev) for k in SimState._fields})


def const_from_arrays(
    d: Mapping[str, object], device: DeviceLike = None
) -> EngineConst:
    """An :class:`EngineConst` on ``device`` from numpy arrays keyed by
    field. ``policy`` is the ten policy flags (a ``PolicyParams`` of either
    engine, or any sequence of bools, in the reference's field order);
    ``tables`` is absent or None (the dense path), or the grouped tables as
    arrays keyed by :class:`GroupTables` field (a mapping, or the
    reference's ``GroupTables``)."""
    dev = resolve_device(device)
    arrays = [k for k in EngineConst._fields if k not in ("policy", "tables")]
    _require(d, arrays + ["policy"])
    flags = [bool(np.asarray(v)) for v in d["policy"]]
    if len(flags) != len(PolicyParams._fields):
        raise ValueError(
            f"policy: expected {len(PolicyParams._fields)} flags, got "
            f"{len(flags)}"
        )
    tables = d.get("tables")
    if tables is not None:
        if not isinstance(tables, Mapping):
            tables = tables._asdict()
        _require(tables, GroupTables._fields)
        tables = GroupTables(
            **{k: _tensor(k, tables[k], dev) for k in GroupTables._fields}
        )
    return EngineConst(
        policy=PolicyParams(*flags),
        tables=tables,
        **{k: _tensor(k, d[k], dev) for k in arrays},
    )


def state_to_arrays(s: SimState) -> Dict[str, np.ndarray]:
    """numpy arrays keyed by field name (copied to the host)."""
    return {k: v.detach().cpu().numpy() for k, v in s._asdict().items()}


def state_rows_to_arrays(s: SimState) -> List[Dict[str, np.ndarray]]:
    """A batched ``[E]`` state (a sweep's) as E dicts of numpy arrays, one a
    row, each keyed like :func:`state_to_arrays` (one copy to the host)."""
    d = state_to_arrays(s)
    return [{k: v[i] for k, v in d.items()} for i in range(d["t"].shape[0])]
