"""Carry a simulation across engines: the reference's state and tables in
numpy form to the port's tensors, and back.

The dict keys are the field names of the reference's ``SimState`` and
``EngineConst`` (identical in the port), so a state taken from the JAX
engine with ``repro.core.metrics.np_state`` continues in the PyTorch engine,
and a port state comes back as numpy arrays of the same names and dtypes.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.engine import EngineConst, SimState
from repro_torch.core.policy import PolicyParams
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
    """A :class:`SimState` on ``device`` from numpy arrays keyed by field."""
    dev = resolve_device(device)
    _require(d, SimState._fields)
    return SimState(**{k: _tensor(k, d[k], dev) for k in SimState._fields})


def const_from_arrays(
    d: Mapping[str, object], device: DeviceLike = None
) -> EngineConst:
    """An :class:`EngineConst` on ``device`` from numpy arrays keyed by
    field. ``policy`` is the ten policy flags (a ``PolicyParams`` of either
    engine, or any sequence of bools, in the reference's field order);
    ``tables`` must be absent or None (grouped tables are not ported yet)."""
    dev = resolve_device(device)
    if d.get("tables") is not None:
        raise NotImplementedError(
            "grouped tables are not ported yet (ROADMAP Queue 1 item 6)"
        )
    arrays = [k for k in EngineConst._fields if k not in ("policy", "tables")]
    _require(d, arrays + ["policy"])
    flags = [bool(np.asarray(v)) for v in d["policy"]]
    if len(flags) != len(PolicyParams._fields):
        raise ValueError(
            f"policy: expected {len(PolicyParams._fields)} flags, got "
            f"{len(flags)}"
        )
    return EngineConst(
        policy=PolicyParams(*flags),
        tables=None,
        **{k: _tensor(k, d[k], dev) for k in arrays},
    )


def state_to_arrays(s: SimState) -> Dict[str, np.ndarray]:
    """numpy arrays keyed by field name (copied to the host)."""
    return {k: v.detach().cpu().numpy() for k, v in s._asdict().items()}
