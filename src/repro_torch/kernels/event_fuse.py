"""The engine's fused event-pass reductions: kernel wrappers and plain versions.

Each function reads the node arrays ``node_state`` and ``node_until`` (``[E,
N]`` i32) once per env row ``e`` and returns a state histogram together with
the next strictly-future transition completion ``[E]`` i32 (the min of
``until`` over SWITCHING_ON/OFF nodes with ``until > t[e]``, ``INF_TIME`` if
none) — the pair ``engine.event_horizon`` needs each batch:

* :func:`event_fuse_ledger` — per-state power sums ``[E, 8]`` f32
  (``count(state == s) * power[s]`` for the five live states, columns 5-7
  zero): the dense single-group path;
* :func:`event_fuse_occ` — per-(group, state) occupancy counts ``[E, G, 8]``
  f32 (columns 5-7 of each group row zero): the grouped-tables path;
* :func:`event_fuse` — the scalar draw ``[E]`` f32 (``sum_s count(state ==
  s) * power[s]``); no engine path calls it.

They replace the TPU kernels of the same names in
``repro/kernels/event_fuse.py``. On a CUDA tensor a wrapper launches its
hand-written kernel in ``csrc/event_fuse.cu`` (or raises); on a CPU tensor it
runs the ``*_plain`` function beside it, the same function in plain PyTorch.
Both count states in integers and combine the counts with the watts in one
fixed order, so on the card each kernel and its plain version agree bit for
bit; against the reference's per-node f32 sums the watts-weighted outputs
agree to f32 rounding (exact for integer watts below 2**24), and the
occupancy counts exactly. The kernels are launch-bound at the engine's E = 1
(see the source).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.types import INF_TIME, N_STATES, SWITCHING_OFF, SWITCHING_ON
from repro_torch.kernels import _build

COLS = 8  # the sums and occupancy rows are padded to 8 columns
KERNELS = ("event_fuse_ledger", "event_fuse_occ", "event_fuse")
# the histogram's G * 8 int32 cells must fit 48 KB of shared memory
MAX_GROUPS = 48 * 1024 // (4 * COLS)

# kernel launches made by each wrapper (the plain route never counts)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "event_fuse_ledger": [_VOIDP] * 6 + [_INT, _INT, _VOIDP],
    "event_fuse": [_VOIDP] * 6 + [_INT, _INT, _VOIDP],
    "event_fuse_occ": [_VOIDP] * 6 + [_INT, _INT, _INT, _VOIDP],
}
_LAUNCH_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNELS:
        LAUNCHES[name] = 0


def _launch_fn(name: str):
    """The ctypes entry point ``<name>_launch``, with its C signature."""
    fn = _LAUNCH_FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("event_fuse"), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _INT
        _LAUNCH_FNS[name] = fn
    return fn


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _state_counts(node_state: torch.Tensor) -> torch.Tensor:
    """i32 [E, 5]: nodes in each live state, per row."""
    return torch.stack(
        [(node_state == s).sum(dim=1, dtype=torch.int32) for s in range(N_STATES)],
        dim=1,
    )


def _next_transition(node_state, node_until, t) -> torch.Tensor:
    switching = (node_state == SWITCHING_ON) | (node_state == SWITCHING_OFF)
    masked = torch.where(
        switching & (node_until > t[:, None]), node_until, int(INF_TIME)
    )
    if node_state.shape[1] == 0:
        return torch.full_like(t, int(INF_TIME))
    return masked.amin(dim=1)


def event_fuse_ledger_plain(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    power: torch.Tensor,  # [5] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (sums [E, 8] f32, next [E] i32)."""
    e = node_state.shape[0]
    sums = torch.zeros((e, COLS), dtype=torch.float32, device=node_state.device)
    sums[:, :N_STATES] = _state_counts(node_state).to(torch.float32) * power
    return sums, _next_transition(node_state, node_until, t)


def event_fuse_plain(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    power: torch.Tensor,  # [5] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (draw [E] f32, next [E] i32). The five
    per-state products are added in the order s = 0..4, as the kernel does."""
    prod = _state_counts(node_state).to(torch.float32) * power
    draw = prod[:, 0]
    for s in range(1, N_STATES):
        draw = draw + prod[:, s]
    return draw, _next_transition(node_state, node_until, t)


def event_fuse_occ_plain(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    group_id: torch.Tensor,  # [N] i32
    n_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (occ [E, G, 8] f32, next [E] i32). Counts are
    int32 (an int32 ``index_add_`` is exact in any order) cast to f32."""
    e, n = node_state.shape
    dev = node_state.device
    live = (
        (node_state >= 0) & (node_state < N_STATES)
        & (group_id >= 0) & (group_id < n_groups)
    )
    cells = n_groups * COLS
    # dead nodes go to the extra cell `cells` of each row, which is dropped
    cell = torch.where(live, group_id * COLS + node_state, cells)
    row = torch.arange(e, device=dev, dtype=torch.int64)[:, None] * (cells + 1)
    counts = torch.zeros(e * (cells + 1), dtype=torch.int32, device=dev)
    counts.index_add_(
        0, (row + cell).reshape(-1), torch.ones(e * n, dtype=torch.int32, device=dev)
    )
    occ = counts.view(e, cells + 1)[:, :cells].to(torch.float32)
    return occ.view(e, n_groups, COLS), _next_transition(node_state, node_until, t)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, node_state, node_until, t, **extra) -> None:
    """Shapes, dtypes and devices the kernel takes: the node arrays [E, N]
    i32, ``t`` [E] i32, and ``extra`` as name=(tensor, shape, dtype)."""
    if node_state.dim() != 2 or node_until.shape != node_state.shape:
        raise ValueError(
            f"{name}: node_state and node_until must be [E, N] of one shape, "
            f"got {tuple(node_state.shape)} and {tuple(node_until.shape)}"
        )
    want = {
        "node_state": (node_state, tuple(node_state.shape), torch.int32),
        "node_until": (node_until, tuple(node_state.shape), torch.int32),
        "t": (t, tuple(node_state.shape[:1]), torch.int32),
        **extra,
    }
    for key, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: {key} must be {list(shape)}, got {tuple(x.shape)}"
            )
        if x.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {x.dtype}")
        if x.device != node_state.device:
            raise ValueError(
                f"{name}: {key} is on {x.device}, node_state on "
                f"{node_state.device}"
            )
    dev = node_state.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if dev.type == "cuda":
        for key, (x, _, _) in want.items():
            if not x.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous")


def _launch(name: str, dev: torch.device, *args) -> None:
    """Launch ``name`` on the current stream of ``dev``; raise if the launch
    was refused; count it."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch (cudaError {err})")
    LAUNCHES[name] += 1


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
    name = "event_fuse_ledger"
    _check(name, node_state, node_until, t,
           power=(power, (N_STATES,), torch.float32))
    e, n = node_state.shape
    dev = node_state.device
    if e == 0 or n == 0:
        return (
            torch.zeros((e, COLS), dtype=torch.float32, device=dev),
            torch.full((e,), int(INF_TIME), dtype=torch.int32, device=dev),
        )
    if dev.type == "cpu":
        return event_fuse_ledger_plain(node_state, node_until, t, power)
    sums = torch.empty((e, COLS), dtype=torch.float32, device=dev)
    nxt = torch.empty((e,), dtype=torch.int32, device=dev)
    _launch(name, dev, node_state.data_ptr(), node_until.data_ptr(),
            t.data_ptr(), power.data_ptr(), sums.data_ptr(), nxt.data_ptr(),
            e, n)
    return sums, nxt


def event_fuse(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    power: torch.Tensor,  # [5] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (power draw [E] f32, next transition [E] i32), with the
    routing and zero-size contract of :func:`event_fuse_ledger`."""
    name = "event_fuse"
    _check(name, node_state, node_until, t,
           power=(power, (N_STATES,), torch.float32))
    e, n = node_state.shape
    dev = node_state.device
    if e == 0 or n == 0:
        return (
            torch.zeros((e,), dtype=torch.float32, device=dev),
            torch.full((e,), int(INF_TIME), dtype=torch.int32, device=dev),
        )
    if dev.type == "cpu":
        return event_fuse_plain(node_state, node_until, t, power)
    draw = torch.empty((e,), dtype=torch.float32, device=dev)
    nxt = torch.empty((e,), dtype=torch.int32, device=dev)
    _launch(name, dev, node_state.data_ptr(), node_until.data_ptr(),
            t.data_ptr(), power.data_ptr(), draw.data_ptr(), nxt.data_ptr(),
            e, n)
    return draw, nxt


def event_fuse_occ(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    group_id: torch.Tensor,  # [N] i32
    n_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (occupancy counts [E, G, 8] f32, next transition [E] i32) —
    the grouped path. ``G = n_groups`` is at most :data:`MAX_GROUPS` (the
    kernel's shared-memory histogram). Routing and zero-size contract as in
    :func:`event_fuse_ledger`."""
    name = "event_fuse_occ"
    n_groups = int(n_groups)
    if not 1 <= n_groups <= MAX_GROUPS:
        raise ValueError(
            f"{name}: n_groups must be in 1..{MAX_GROUPS}, got {n_groups}"
        )
    _check(name, node_state, node_until, t,
           group_id=(group_id, tuple(node_state.shape[1:]), torch.int32))
    e, n = node_state.shape
    dev = node_state.device
    if e == 0 or n == 0:
        return (
            torch.zeros((e, n_groups, COLS), dtype=torch.float32, device=dev),
            torch.full((e,), int(INF_TIME), dtype=torch.int32, device=dev),
        )
    if dev.type == "cpu":
        return event_fuse_occ_plain(node_state, node_until, t, group_id, n_groups)
    occ = torch.empty((e, n_groups, COLS), dtype=torch.float32, device=dev)
    nxt = torch.empty((e,), dtype=torch.int32, device=dev)
    _launch(name, dev, node_state.data_ptr(), node_until.data_ptr(),
            t.data_ptr(), group_id.data_ptr(), occ.data_ptr(), nxt.data_ptr(),
            e, n, n_groups)
    return occ, nxt
