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

The ledger's watts ``power`` and the occupancy's ``group_id`` are either
one table for every row (``[5]``, ``[N]``) or one table a row (``[E, 5]``,
``[E, N]``: a sweep whose scenarios differ in their platform); the kernel
reads a row's table at a row offset, 0 for the shared form.
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
occupancy counts exactly. The kernels are bound by latency at the engine's
E = 1: the ledger and occupancy kernels split each row over a thread-block
cluster of :func:`cluster_size` CTAs and reduce it through distributed shared
memory (see the source), and their wrappers keep the host's work per call
small: a check that builds no message unless it fails, one allocation for
both outputs, and the launch's set-up cached per kernel, device and shape.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.core.types import INF_TIME, N_STATES, SWITCHING_OFF, SWITCHING_ON
from repro_torch.kernels import _build

COLS = 8  # the sums and occupancy rows are padded to 8 columns
KERNELS = ("event_fuse_ledger", "event_fuse_occ", "event_fuse")
# a CTA's histogram and its cluster's accumulator, G * 8 int32 cells each,
# must fit the 96 KB of shared memory the occupancy kernel is allowed
MAX_GROUPS = 48 * 1024 // (4 * COLS)
# the ledger and occupancy kernels split a row over a cluster of up to 16
# CTAs (see :func:`cluster_size`), each CTA keeping at least this many nodes
# of its row: the ledger's CTAs do less work a node, so they take more
MAX_CLUSTER = 16
MIN_CTA_NODES = {"event_fuse_ledger": 2048, "event_fuse_occ": 512}
CTAS_PER_SM = 2

# kernel launches made by each wrapper (the plain route never counts)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# the cluster size of each cluster kernel's last launch
CLUSTER: Dict[str, int] = {}

_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "event_fuse_ledger": [_VOIDP] * 5 + [_INT] * 4 + [_VOIDP],
    "event_fuse": [_VOIDP] * 6 + [_INT, _INT, _VOIDP],
    "event_fuse_occ": [_VOIDP] * 5 + [_INT] * 5 + [_VOIDP],
}
# the order of event_fuse_cluster_setup's `which`
_CLUSTER_KERNELS = ("event_fuse_ledger", "event_fuse_occ")
# (name, device index, E, N) -> (entry point, cluster size) of a launch
_PLANS: Dict[Tuple[str, int, int, int], Tuple[object, int]] = {}
# the current CUDA stream of a device index, as an int; the current device
_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                  lambda idx: torch.cuda.current_stream(idx).cuda_stream)
_current_device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNELS:
        LAUNCHES[name] = 0


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
    power: torch.Tensor,  # [5] or [E, 5] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (sums [E, 8] f32, next [E] i32); a ``[5]``
    ``power`` broadcasts over the rows."""
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
    group_id: torch.Tensor,  # [N] or [E, N] i32
    n_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (occ [E, G, 8] f32, next [E] i32); an ``[N]``
    ``group_id`` broadcasts over the rows. Counts are int32 (an int32
    ``index_add_`` is exact in any order) cast to f32."""
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

def cluster_size(e: int, n: int, sms: int, max_cluster: int, min_nodes: int) -> int:
    """The cluster size C (a power of two) for an ``[E, N]`` call of a
    cluster kernel on a card of ``sms`` SMs that holds clusters of up to
    ``max_cluster``: each row is split over C CTAs, so that the grid's ``E *
    C`` CTAs reach ``CTAS_PER_SM`` per SM while each CTA keeps at least
    ``min_nodes`` nodes of its row (``MIN_CTA_NODES`` of the kernel). At E =
    1 and N = 11 200 on an H100 (132 SMs): 16 for the occupancy kernel, 4
    for the ledger; 1 for a row under ``2 * min_nodes`` nodes."""
    want = min(max_cluster, n // min_nodes, -(-CTAS_PER_SM * sms // max(e, 1)))
    c = 1
    while 2 * c <= want:
        c *= 2
    return c


def _check(name, node_state, node_until, t, key, x, shape, dtype,
           per_row=False) -> torch.device:
    """The call's device, once the arguments are what the kernel takes: the
    node arrays [E, N] i32, ``t`` [E] i32 and the argument ``key``, ``x``,
    of ``shape`` (or, with ``per_row``, of ``[E, *shape]``: one table a row)
    and ``dtype``, all on one cpu or cuda device and, on cuda, contiguous. A
    message is built only for the fault that raises."""
    shp = node_state.shape
    if len(shp) != 2 or node_until.shape != shp:
        raise ValueError(
            f"{name}: node_state and node_until must be [E, N] of one shape, "
            f"got {tuple(shp)} and {tuple(node_until.shape)}"
        )
    dev = node_state.device
    want = (("node_state", node_state, shp, torch.int32),
            ("node_until", node_until, shp, torch.int32),
            ("t", t, shp[:1], torch.int32),
            (key, x, shape, dtype))
    for k, a, a_shape, a_dtype in want:
        if a.shape != a_shape and not (k == key and per_row
                                       and a.shape == shp[:1] + a_shape):
            also = (f" or {list(shp[:1] + a_shape)} (one table a row)"
                    if k == key and per_row else "")
            raise ValueError(
                f"{name}: {k} must be {list(a_shape)}, got {tuple(a.shape)}{also}"
            )
        if a.dtype != a_dtype:
            raise TypeError(f"{name}: {k} must be {a_dtype}, got {a.dtype}")
        if a.device != dev:
            raise ValueError(f"{name}: {k} is on {a.device}, node_state on {dev}")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for k, a, _, _ in want:
        if not a.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dev


def cluster_setup(name: str, idx: int) -> Tuple[int, int]:
    """(largest cluster size, SM count) of the cluster kernel ``name`` on
    CUDA device ``idx``: the kernel is allowed clusters of up to 16 CTAs and
    the card says the largest it holds. Raises if the card refuses."""
    setup = _build.load("event_fuse").event_fuse_cluster_setup
    setup.argtypes = [_INT, ctypes.POINTER(_INT)]
    setup.restype = _INT
    max_c = _INT(0)
    with torch.cuda.device(idx):
        err = setup(_CLUSTER_KERNELS.index(name), ctypes.byref(max_c))
    if err != 0:
        raise RuntimeError(f"{name}: the card refused the cluster set-up (cudaError {err})")
    return max_c.value, torch.cuda.get_device_properties(idx).multi_processor_count


def _plan(name: str, idx: int, e: int, n: int) -> Tuple[object, int]:
    """(ctypes entry point ``<name>_launch``, cluster size) of ``name`` at
    ``[E, N]`` on CUDA device ``idx``, set up once (the cluster size is 1
    for ``event_fuse``, which runs one block a row)."""
    plan = _PLANS.get((name, idx, e, n))
    if plan is None:
        fn = getattr(_build.load("event_fuse"), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _INT
        c = 1
        if name in _CLUSTER_KERNELS:
            max_c, sms = cluster_setup(name, idx)
            c = cluster_size(e, n, sms, max_c, MIN_CTA_NODES[name])
        plan = _PLANS[(name, idx, e, n)] = (fn, c)
    return plan


def _launch(name: str, idx: int, fn, *args) -> None:
    """Launch ``fn`` on the current stream of CUDA device ``idx`` (entering
    the device only when it is not the current one); raise if the launch was
    refused; count it."""
    if idx == _current_device():
        err = fn(*args, _stream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, _stream(idx))
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch (cudaError {err})")
    LAUNCHES[name] += 1


def _outputs(like: torch.Tensor, shape, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One allocation on the device of the i32 tensor ``like``, holding an
    f32 ``shape`` (``[E, ...]``) and, right after it, the i32 ``[E]`` next
    transition: two views of it."""
    cells = math.prod(shape)
    vals, nxt = like.new_empty(cells + e).split_with_sizes([cells, e])
    return vals.view(torch.float32).view(*shape), nxt


def _empty_pair(shape, e: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The zero-size answer: zeros and ``INF_TIME``."""
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.full((e,), int(INF_TIME), dtype=torch.int32, device=device))


def event_fuse_ledger(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    power: torch.Tensor,  # [5] or [E, 5] f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (per-state power sums [E, 8] f32, next transition [E] i32),
    with the watts ``power`` shared by the rows (``[5]``) or one table a row
    (``[E, 5]``).

    CUDA tensors launch the kernel (and raise if it cannot launch); CPU
    tensors take the plain version. Zero-size ``E`` or ``N`` short-circuits:
    sums are 0 and the next transition is ``INF_TIME``. On the card both
    outputs are views of one allocation.
    """
    name = "event_fuse_ledger"
    dev = _check(name, node_state, node_until, t, "power", power, (N_STATES,),
                 torch.float32, per_row=True)
    e, n = node_state.shape
    if e == 0 or n == 0:
        return _empty_pair((e, COLS), e, dev)
    if dev.type == "cpu":
        return event_fuse_ledger_plain(node_state, node_until, t, power)
    fn, c = _plan(name, dev.index, e, n)
    sums, nxt = _outputs(node_state, (e, COLS), e)
    _launch(name, dev.index, fn, node_state.data_ptr(), node_until.data_ptr(),
            t.data_ptr(), power.data_ptr(), sums.data_ptr(), e, n, c,
            N_STATES if power.dim() == 2 else 0)
    CLUSTER[name] = c
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
    dev = _check(name, node_state, node_until, t, "power", power, (N_STATES,),
                 torch.float32)
    e, n = node_state.shape
    if e == 0 or n == 0:
        return _empty_pair((e,), e, dev)
    if dev.type == "cpu":
        return event_fuse_plain(node_state, node_until, t, power)
    draw = torch.empty((e,), dtype=torch.float32, device=dev)
    nxt = torch.empty((e,), dtype=torch.int32, device=dev)
    fn, _ = _plan(name, dev.index, e, n)
    _launch(name, dev.index, fn, node_state.data_ptr(), node_until.data_ptr(),
            t.data_ptr(), power.data_ptr(), draw.data_ptr(), nxt.data_ptr(), e, n)
    return draw, nxt


def event_fuse_occ(
    node_state: torch.Tensor,  # [E, N] i32
    node_until: torch.Tensor,  # [E, N] i32
    t: torch.Tensor,  # [E] i32
    group_id: torch.Tensor,  # [N] or [E, N] i32
    n_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (occupancy counts [E, G, 8] f32, next transition [E] i32) —
    the grouped path, with the group ids shared by the rows (``[N]``) or one
    table a row (``[E, N]``). ``G = n_groups`` is at most :data:`MAX_GROUPS`
    (the kernel's shared-memory histogram). Routing, zero-size contract and
    the one allocation as in :func:`event_fuse_ledger`."""
    name = "event_fuse_occ"
    n_groups = int(n_groups)
    if not 1 <= n_groups <= MAX_GROUPS:
        raise ValueError(
            f"{name}: n_groups must be in 1..{MAX_GROUPS}, got {n_groups}"
        )
    dev = _check(name, node_state, node_until, t, "group_id", group_id,
                 node_state.shape[1:], torch.int32, per_row=True)
    e, n = node_state.shape
    if e == 0 or n == 0:
        return _empty_pair((e, n_groups, COLS), e, dev)
    if dev.type == "cpu":
        return event_fuse_occ_plain(node_state, node_until, t, group_id, n_groups)
    fn, c = _plan(name, dev.index, e, n)
    occ, nxt = _outputs(node_state, (e, n_groups, COLS), e)
    _launch(name, dev.index, fn, node_state.data_ptr(), node_until.data_ptr(),
            t.data_ptr(), group_id.data_ptr(), occ.data_ptr(), e, n, n_groups, c,
            n if group_id.dim() == 2 else 0)
    CLUSTER[name] = c
    return occ, nxt
