"""Elastic resharding: continue when the worker set shrinks or grows — the
port of the reference's ``training/elastic.py``.

The reference's recovery path is: detect (the straggler watchdog or a dead
collective), rebuild the mesh over the surviving devices, reshard the live
state, resume; its state is a pytree of ``jax.Array``\\ s, so a reshard is one
``device_put`` against the new mesh. The port's mesh is
:class:`~repro_torch.core.shard.Mesh`, worker processes, one per card, so:

* :func:`surviving_mesh` is the mesh of the surviving workers, a ``(data,
  model)`` grid of ``n_devices // model_parallel`` x ``model_parallel``
  workers (``shard.Mesh.shape``); :func:`reshard` places trees on a mesh
  without a model axis (model 1): resharding a model-sharded state raises
  ``NotImplementedError`` naming ROADMAP Queue 1 item 12c.6;
* :func:`reshard` places a tensor tree in the mesh's workers: each leaf
  split over the workers along its leading axis (:data:`SPLIT`, the
  reference's ``P("data", None)``, cut as ``shard.block_bounds`` cuts) or
  copied whole to each (:data:`REPLICATE`, ``P()``), as ``sharding_fn``
  says leaf by leaf. It returns a :class:`Placed`, whose :meth:`Placed.gather`
  brings the tree back; resharding a :class:`Placed` gathers it through the
  parent as CPU tensors and places it again (every block moves, not only
  those that change owner). Values, dtypes and shapes are kept bit for bit.

Semantics kept across a resize, as the reference's:

* params and optimizer state: value-identical;
* the global batch: constant — the per-device batch rescales, and where the
  new data-parallel degree no longer divides it, gradient accumulation
  absorbs the rest (:func:`plan_batch`);
* RL envs (a leading env axis): surplus envs past an even split are dropped
  from the tail (:func:`shrink_env_axis`), and new slots take copies of the
  live envs (:func:`grow_env_axis`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core import shard
from repro_torch.launch.mesh import make_host_mesh

PyTree = Any

SPLIT = "split"  # the leading axis in contiguous blocks, one a worker
REPLICATE = "replicate"  # the whole leaf on every worker
PLACEMENTS = (SPLIT, REPLICATE)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    global_batch: int
    per_device: int
    accum_steps: int
    dp_degree: int


def plan_batch(global_batch: int, dp_degree: int, max_per_device: int) -> BatchPlan:
    """Keep global batch fixed as DP degree changes; spill into accumulation."""
    per_replica = global_batch // dp_degree
    if global_batch % dp_degree != 0:
        raise ValueError(
            f"global_batch {global_batch} not divisible by dp={dp_degree}; "
            "choose a batch with enough factors for elastic range"
        )
    accum = 1
    while per_replica // accum > max_per_device or per_replica % accum != 0:
        accum += 1
        if accum > per_replica:
            raise ValueError("cannot satisfy max_per_device")
    return BatchPlan(global_batch, per_replica // accum, accum, dp_degree)


def shrink_env_axis(tree: PyTree, new_count: int) -> PyTree:
    """Drop surplus envs from the tail of the leading axis (deterministic;
    compact copies)."""
    return shard.tree_map(lambda x: x[:new_count].clone(), tree)


def grow_env_axis(tree: PyTree, new_count: int) -> PyTree:
    """Tile existing envs to fill new slots (fresh resets happen next step)."""

    def leaf(x):
        reps = -(-new_count // x.shape[0])  # ceil
        return x.repeat((reps,) + (1,) * (x.ndim - 1))[:new_count]

    return shard.tree_map(leaf, tree)


def surviving_mesh(
    n_devices: int, model_parallel: int,
    axis_names: Tuple[str, str] = ("data", "model"), device=None,
) -> shard.Mesh:
    """The largest mesh on the surviving devices: ``launch/mesh.py``'s
    ``make_host_mesh`` grid of ``(n_devices // model_parallel) *
    model_parallel`` workers under ``axis_names`` (``cuda`` unless the
    caller passes ``"cpu"``; more workers than visible cards raise)."""
    if model_parallel < 1 or len(axis_names) != 2:
        raise ValueError(f"model_parallel must be >= 1 with two axis names, got "
                         f"{model_parallel} and {axis_names!r}")
    usable = (n_devices // model_parallel) * model_parallel
    if usable < 1:
        raise ValueError(f"no device survives: n_devices={n_devices}")
    return make_host_mesh(model_parallel, usable, device, axis_names)


# ---------------------------------------------------------------------------
# placing a tree in the workers
# ---------------------------------------------------------------------------

def _open(tree: PyTree) -> PyTree:
    return shard.to_device(tree, shard.worker_device())


def _fetch(tree: PyTree) -> PyTree:
    return shard.to_host(tree)


class Placed:
    """A tree placed in a mesh's workers by :func:`reshard`: worker ``d``
    holds its block of every :data:`SPLIT` leaf and a copy of every
    :data:`REPLICATE` one. :meth:`gather` returns the tree; :meth:`close`
    frees the workers' copies (also when the handle is collected)."""

    def __init__(self, tree: PyTree, mesh: shard.Mesh, placements: PyTree,
                 device: torch.device, shapes: PyTree):
        D = len(mesh)

        def check(x, where):
            if where not in PLACEMENTS:
                raise ValueError(f"a placement is one of {PLACEMENTS}, got {where!r}")
            if where == SPLIT and x.ndim == 0:
                raise ValueError("a 0-d leaf cannot split along a leading axis")
            return x

        shard.tree_map(check, tree, placements)
        self.mesh, self.placements, self.device, self.shapes = mesh, placements, device, shapes

        def block(d):
            def share(x, where):  # a compact CPU copy of worker d's share
                if where == SPLIT:
                    lo, hi = shard.block_bounds(x.shape[0], D)[d]
                    x = x[lo:hi]
                return x.to("cpu", copy=True)
            return (shard.tree_map(share, tree, placements),)

        self._resident = mesh.resident(_open, [block(d) for d in range(D)])

    def gather(self, device=None) -> PyTree:
        """The tree on ``device`` (the placed tree's device by default):
        split leaves concatenated in worker order, replicated ones worker
        0's copy."""
        dev = self.device if device is None else torch.device(device)

        def leaf(_, where, *parts):
            return (torch.cat(parts) if where == SPLIT else parts[0]).to(dev)

        parts = self._resident.call(_fetch)
        return shard.tree_map(leaf, self.shapes, self.placements, *parts)

    def close(self) -> None:
        self._resident.close()


def reshard(
    tree: PyTree,
    new_mesh: shard.Mesh,
    sharding_fn: Callable[[shard.Mesh, Any], PyTree],
) -> Placed:
    """Place a live tree (or a :class:`Placed`, gathered first through the
    parent) in ``new_mesh``'s workers. ``sharding_fn(mesh, shapes)`` gets
    the tree as meta tensors (the reference's ``jax.eval_shape``) and
    returns a tree of the same structure holding :data:`SPLIT` or
    :data:`REPLICATE` for each tensor."""
    model = list(new_mesh.shape.values())[1:]
    if any(size > 1 for size in model):
        raise NotImplementedError(
            f"resharding onto a mesh of shape {new_mesh.shape}: a model-sharded state "
            "is ROADMAP Queue 1 item 12c.6 (the port reshards along the data axis)")
    if isinstance(tree, Placed):
        device, tree = tree.device, tree.gather("cpu")
    else:
        device = next((x.device for x in shard.leaves(tree)), torch.device("cpu"))
    shapes = shard.tree_map(lambda x: torch.empty_like(x, device="meta"), tree)
    return Placed(tree, new_mesh, sharding_fn(new_mesh, shapes), device, shapes)
