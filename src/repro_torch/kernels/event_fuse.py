"""The engine's fused event-pass reduction: kernel wrapper and plain version.

``event_fuse_ledger(node_state, node_until, t, power)`` returns, per env row
``e``, the per-state power sums ``[E, 8]`` f32 (``count(state == s) *
power[s]`` for the five live states, columns 5-7 zero) and the next
strictly-future transition completion ``[E]`` i32 (the min of ``until`` over
SWITCHING_ON/OFF nodes with ``until > t[e]``, ``INF_TIME`` if none) — the
histogram and masked min that ``engine.event_horizon`` needs each batch, in
one read of the node arrays.

It replaces the TPU kernel ``repro/kernels/event_fuse.py::event_fuse_ledger``.
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/event_fuse.cu`` (or raises); on a CPU tensor it runs
:func:`event_fuse_ledger_plain`, the same function in plain PyTorch. Both
count states in integers and multiply once by the watts, so on the card the
kernel and the plain version agree bit for bit; against the reference's
per-node f32 sum they agree to f32 rounding (exact for integer watts below
2**24). The kernel is launch-bound at the engine's E = 1 (see the source).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.types import INF_TIME, N_STATES, SWITCHING_OFF, SWITCHING_ON
from repro_torch.kernels import _build

COLS = 8  # the sums row is padded to 8 columns, like the reference kernel's

# kernel launches made by event_fuse_ledger (the plain route never counts)
LAUNCHES = 0

_LAUNCH_FN = None


def _launch_fn():
    """The ctypes entry point, with its C signature declared."""
    global _LAUNCH_FN
    if _LAUNCH_FN is None:
        fn = _build.load("event_fuse").event_fuse_ledger_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _LAUNCH_FN = fn
    return _LAUNCH_FN


def event_fuse_ledger_plain(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    power: torch.Tensor,  # [5] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (sums [E, 8] f32, next [E] i32)."""
    e, n = node_state.shape
    counts = torch.stack(
        [(node_state == s).sum(dim=1, dtype=torch.int32) for s in range(N_STATES)],
        dim=1,
    )
    sums = torch.zeros((e, COLS), dtype=torch.float32, device=node_state.device)
    sums[:, :N_STATES] = counts.to(torch.float32) * power
    switching = (node_state == SWITCHING_ON) | (node_state == SWITCHING_OFF)
    masked = torch.where(
        switching & (node_until > t[:, None]), node_until, int(INF_TIME)
    )
    if n == 0:
        return sums, torch.full_like(t, int(INF_TIME))
    return sums, masked.amin(dim=1)


def _check(node_state, node_until, t, power) -> None:
    if node_state.dim() != 2 or node_until.shape != node_state.shape:
        raise ValueError(
            "node_state and node_until must be [E, N] of one shape, got "
            f"{tuple(node_state.shape)} and {tuple(node_until.shape)}"
        )
    if t.shape != node_state.shape[:1] or power.shape != (N_STATES,):
        raise ValueError(
            f"t must be [E] and power [{N_STATES}], got {tuple(t.shape)} "
            f"and {tuple(power.shape)}"
        )
    for name, x, dtype in (
        ("node_state", node_state, torch.int32),
        ("node_until", node_until, torch.int32),
        ("t", t, torch.int32),
        ("power", power, torch.float32),
    ):
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != node_state.device:
            raise ValueError(
                f"{name} is on {x.device}, node_state on {node_state.device}"
            )


def event_fuse_ledger(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    power: torch.Tensor,  # [5] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (per-state power sums [E, 8] f32, next transition [E] i32).

    CUDA tensors launch the kernel (and raise if it cannot launch); CPU
    tensors take the plain version. Zero-size ``E`` or ``N`` short-circuits:
    sums are 0 and the next transition is ``INF_TIME``.
    """
    global LAUNCHES
    _check(node_state, node_until, t, power)
    e, n = node_state.shape
    dev = node_state.device
    if e == 0 or n == 0:
        return (
            torch.zeros((e, COLS), dtype=torch.float32, device=dev),
            torch.full((e,), int(INF_TIME), dtype=torch.int32, device=dev),
        )
    if dev.type == "cpu":
        return event_fuse_ledger_plain(node_state, node_until, t, power)
    if dev.type != "cuda":
        raise ValueError(f"event_fuse_ledger runs on cuda or cpu, not {dev}")
    for name, x in (
        ("node_state", node_state), ("node_until", node_until),
        ("t", t), ("power", power),
    ):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sums = torch.empty((e, COLS), dtype=torch.float32, device=dev)
    nxt = torch.empty((e,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn()(
            node_state.data_ptr(), node_until.data_ptr(), t.data_ptr(),
            power.data_ptr(), sums.data_ptr(), nxt.data_ptr(), e, n, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"event_fuse_ledger kernel failed to launch (cudaError {err})"
        )
    LAUNCHES += 1
    return sums, nxt
