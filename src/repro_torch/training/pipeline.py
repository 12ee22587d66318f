"""GPipe-style pipeline parallelism over worker processes — the port of the
reference's ``training/pipeline.py`` (``shard_map`` and ``ppermute`` over a
mesh axis).

The reference splits a scan-over-layers stack into ``n_stages`` contiguous
stages, holds one stage on each rank of a mesh axis and moves microbatched
activations rank to rank with ``jax.lax.ppermute``, on the classic fill-drain
schedule of ``n_micro + n_stages - 1`` ticks: rank ``r`` works on microbatch
``t - r`` at tick ``t``, so the bubble is ``(S - 1) / (M + S - 1)``.

Here a rank is a worker process of a :class:`~repro_torch.core.shard.Mesh`
(one per card, or several pinned to one card), and its length is the stage
count; ``axis`` names its one axis and selects nothing:

* :func:`place_stages` moves each stage's parameters to its worker's device
  once, as a :class:`~repro_torch.core.shard.Resident`; :func:`pipeline_forward`
  places them itself when given the stacked tree, and frees them after;
* at each tick the parent submits every active rank's stage together, so
  the stages overlap across workers, waits, and hands each output to the
  next rank. That hop through the parent stands in for ``ppermute``: the
  activation goes card to host, is pickled, and goes host to card (only CPU
  tensors cross a process boundary; no CUDA IPC);
* a rank outside the schedule at a tick computes nothing (the reference
  computes on a placeholder and discards it; the results are the same);
* the result is one tensor ``[n_micro, mb, ...]`` on ``x``'s device. The
  reference's closing broadcast and ``psum``, which give every rank the
  outputs, have no counterpart: the parent collects them from the last rank.

The stage function crosses to the workers pickled, so it is a module-level
function or a ``functools.partial`` of one (:func:`make_stage_fn` of such a
function is); a lambda or a closure raises ``ValueError`` before any worker
starts. Activation shapes must be rank-invariant, which holds for every
homogeneous trunk.

:func:`stack_blocks` and :func:`dense_block_apply` make a model trunk of
the port's ``Transformer``: the stacked parameters of a run of its
``DenseBlock``\\ s, and one such block applied with
``torch.func.functional_call`` — the reference's ``block_apply(lp, x, cfg,
"dense", positions, {})[0]``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
from torch.func import functional_call, stack_module_state

from repro_torch.configs.base import ArchConfig
from repro_torch.core import shard
from repro_torch.device import resolve_device

PyTree = Any


def split_stages(stacked_params: PyTree, n_stages: int) -> PyTree:
    """``[L, ...]`` layer-stacked params -> ``[n_stages, L/n_stages, ...]``
    (views)."""

    def leaf(a):
        n = a.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return a.reshape((n_stages, n // n_stages) + tuple(a.shape[1:]))

    return shard.tree_map(leaf, stacked_params)


def _index(tree: PyTree, i: int) -> PyTree:
    return shard.tree_map(lambda a: a[i], tree)


def _stage_apply(block_apply, stage_params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Apply ``block_apply`` once per layer of the stage's leading axis."""
    for i in range(shard.leaves(stage_params)[0].shape[0]):
        x = block_apply(_index(stage_params, i), x)
    return x


def make_stage_fn(
    block_apply: Callable[[PyTree, torch.Tensor], torch.Tensor],
) -> Callable[[PyTree, torch.Tensor], torch.Tensor]:
    """Wrap a single-layer apply into a loop over the stage's layer stack
    (the reference's ``lax.scan``). Picklable when ``block_apply`` is."""
    return functools.partial(_stage_apply, block_apply)


# ---------------------------------------------------------------------------
# the workers' side
# ---------------------------------------------------------------------------

def _host_copy(x: torch.Tensor) -> torch.Tensor:
    """A compact CPU copy: a view would carry its whole storage across."""
    return x.to("cpu", copy=True)


def _open_stage(params: PyTree) -> PyTree:
    return shard.to_device(params, shard.worker_device())


def _run_stage(params: PyTree, stage_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        y = stage_fn(params, shard.to_device(x, shard.worker_device()))
    return _host_copy(y)


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def stage_mesh(n_stages: int, device=None) -> shard.Mesh:
    """The mesh of ``n_stages`` worker processes on ``device``'s type
    (``cuda`` unless the caller passes ``"cpu"``; raises without a card)."""
    return shard.mesh(n_stages, resolve_device(device))


def place_stages(stage_params: PyTree, mesh: shard.Mesh) -> shard.Resident:
    """Stage ``r`` of ``stage_params`` (leaves ``[n_stages, ...]``) on
    worker ``r``'s device, kept there until the handle is closed."""
    leaves = shard.leaves(stage_params)
    if not leaves or any(a.ndim == 0 or a.shape[0] != len(mesh) for a in leaves):
        raise ValueError(
            f"stage_params' leaves must lead with the {len(mesh)} stages of the mesh, "
            f"got shapes {[tuple(a.shape) for a in leaves]}")
    resolve_device(mesh.device_type)
    stages = [(shard.tree_map(_host_copy, _index(stage_params, r)),)
              for r in range(len(mesh))]
    return mesh.resident(_open_stage, stages)


def pipeline_forward(
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stage_params: Union[PyTree, shard.Resident],
    x: torch.Tensor,
    *,
    mesh: shard.Mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Run ``x`` ``[n_micro, mb, ...]`` through the stage pipeline; returns
    the ``[n_micro, mb, ...]`` outputs on ``x``'s device.

    ``stage_params`` is the stacked tree (leaves ``[n_stages, ...]``, placed
    for this call and freed after) or :func:`place_stages`' handle on
    ``mesh``. Rank ``r`` processes microbatch ``m`` at tick ``t = m + r``;
    the parent carries each output to the next rank and collects the last
    rank's. A worker's exception raises here; nothing is rerun."""
    if not isinstance(axis, str):
        raise TypeError(f"axis names the mesh's one axis, got {axis!r}")
    shard.dumps(stage_fn, "the stage function")  # a lambda fails before any worker starts
    n_stages, n_micro = len(mesh), x.shape[0]
    placed = stage_params if isinstance(stage_params, shard.Resident) else None
    if placed is not None and (placed.mesh.device_type, placed.mesh.cards) != (
            mesh.device_type, mesh.cards):
        raise ValueError("stage_params were placed on another mesh")
    if placed is None:
        placed = place_stages(stage_params, mesh)
    try:
        outs: list = [None] * n_micro
        carry: list = [None] * n_stages  # the activation entering each rank
        for t in range(n_micro + n_stages - 1):
            args: list = [None] * n_stages
            for r in range(n_stages):
                if 0 <= t - r < n_micro:
                    args[r] = (stage_fn, _host_copy(x[t]) if r == 0 else carry[r])
            for r, y in enumerate(placed.call_each(_run_stage, args)):
                if y is None:
                    continue
                if r == n_stages - 1:
                    outs[t - r] = y
                else:
                    carry[r + 1] = y
        return torch.stack(outs).to(x.device)
    finally:
        if placed is not stage_params:
            placed.close()


# ---------------------------------------------------------------------------
# a model trunk: the port's dense blocks
# ---------------------------------------------------------------------------

def stack_blocks(blocks: Sequence[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """The blocks' parameters stacked on a leading layer axis, by name (a
    copy, ``torch.func.stack_module_state``); the blocks hold no buffers."""
    params, buffers = stack_module_state(list(blocks))
    if buffers:
        raise ValueError(f"blocks with buffers {sorted(buffers)} do not stack here")
    return params


@functools.lru_cache(maxsize=8)
def _skeleton(cfg: ArchConfig) -> torch.nn.Module:
    """A ``DenseBlock`` of ``cfg`` on the meta device: its code, no memory."""
    from repro_torch.models.transformer import DenseBlock

    with torch.device("meta"):
        return DenseBlock(cfg)


def dense_block_apply(cfg: ArchConfig, positions: Optional[torch.Tensor], attn_impl: str,
                      layer_params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """One ``dense`` block of ``cfg`` with ``layer_params`` (one layer of
    :func:`stack_blocks`) on ``x`` ``[B, S, D]``: the reference's
    ``block_apply(lp, x, cfg, "dense", positions, {})[0]``. ``positions``
    None is ``arange(S)`` on ``x``'s device. Bind the first three
    arguments with ``functools.partial`` to make a ``block_apply``."""
    pos = (torch.arange(x.shape[-2], device=x.device) if positions is None
           else positions.to(x.device))
    return functional_call(_skeleton(cfg), layer_params, (x, pos),
                           {"attn_impl": attn_impl})
