"""Group-indexed platform tables — the counterpart of the JAX reference's
``core/tables.py`` (its ``core/SEMANTICS.md`` §Group-indexed tables).

At CEA-Curie scale (11 200 nodes) a real platform has only a few distinct
node kinds (Curie: thin, hybrid and large). :class:`GroupTables` lowers a
:class:`~repro_torch.workloads.platform.PlatformSpec` to per-group tensors so
the grouped engine path can

- accrue energy as the contraction ``occ[G, 5] * power[G, 5]`` over the
  per-(group, state) occupancy histogram carried in ``SimState.occ``, and
- hoist its node order out of the per-attempt loop: ``perm`` once per
  scheduler pass (re-sorted by ready time unless the policy is eager), with
  the nodes selected by a masked cumsum over it.

The lowering runs on the host in numpy, with the reference's f32 key
expressions and stable sort, and the result is moved to the engine's device
once. Groups must be internally uniform for it to be exact:
:func:`group_tables` refuses a platform whose per-node tables vary within a
group rather than averaging them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import ACTIVE, IDLE
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.workloads.platform import PlatformSpec

__all__ = ["GroupTables", "group_tables"]


class GroupTables(NamedTuple):
    """Per-group platform tables plus the static allocation order.

    ``perm`` is the one per-node member: the stable argsort of
    ``(order_key, nid)`` (the identity for ``node_order`` "id" and "pack",
    whose key is per-pass state). Under an eager policy every eligible node
    is ready at ``t``, so ``perm`` is the allocation order itself.
    """

    count: torch.Tensor  # i32[G] nodes per group
    start: torch.Tensor  # i32[G] first node id of the group (ids contiguous)
    power: torch.Tensor  # f32[G, 5] per-state watts
    t_on: torch.Tensor  # i32[G] switch-on delay (s)
    t_off: torch.Tensor  # i32[G] switch-off delay (s)
    speed: torch.Tensor  # f32[G] compute speed
    order_key: torch.Tensor  # f32[G] allocation preference (lower first)
    perm: torch.Tensor  # i32[N] static node order by (order_key, nid)


def _uniform_rows(name: str, table: np.ndarray, gid: np.ndarray, G: int):
    """First row of each group, verifying the table is constant per group."""
    starts = np.searchsorted(gid, np.arange(G))
    rep = table[starts]
    if not np.array_equal(table, rep[gid]):
        raise ValueError(
            f"grouped tables need per-group-uniform platforms, but "
            f"{name!r} varies within a node group (per-node JSON platforms "
            "with intra-group variation must use the dense path: "
            "EngineConfig(grouped_tables=False))"
        )
    return rep


def group_tables(
    platform: PlatformSpec, config, device: DeviceLike = None
) -> GroupTables:
    """Lower ``platform`` to :class:`GroupTables` on ``device`` (``cuda``
    unless the caller passes ``"cpu"``).

    ``config`` contributes only ``node_order``, with the dense path's key
    spellings: ``"idle-watts"`` keys on idle draw, ``"cheap"`` on active
    watts per unit work, and ``"id"``/``"pack"`` carry no static key.
    """
    dev = resolve_device(device)
    N = platform.nb_nodes
    G = platform.n_groups()
    gid = np.asarray(platform.node_group_id(), np.int32)
    counts = np.bincount(gid, minlength=G).astype(np.int32)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int32)
    if platform.node_groups:
        power = _uniform_rows(
            "power", np.asarray(platform.node_power_table(), np.float32),
            gid, G,
        )
        t_on = _uniform_rows(
            "t_on", np.asarray(platform.node_t_switch_on(), np.int32), gid, G
        )
        t_off = _uniform_rows(
            "t_off", np.asarray(platform.node_t_switch_off(), np.int32),
            gid, G,
        )
        speed = _uniform_rows(
            "speed", np.asarray(platform.node_speed(), np.float32), gid, G
        )
    else:
        power = np.asarray(platform.power_table(), np.float32)[None, :]
        t_on = np.asarray([platform.t_switch_on], np.int32)
        t_off = np.asarray([platform.t_switch_off], np.int32)
        speed = np.asarray([platform.speed()], np.float32)
    # the same f32 key expressions as the dense order_key
    if config.node_order == "idle-watts":
        okey_g = power[:, IDLE].astype(np.float32)
    else:
        okey_g = (power[:, ACTIVE] / speed).astype(np.float32)
    if config.node_order in ("id", "pack"):
        perm = np.arange(N, dtype=np.int32)
    else:
        perm = np.argsort(okey_g[gid], kind="stable").astype(np.int32)

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    return GroupTables(
        count=t(counts, torch.int32),
        start=t(starts, torch.int32),
        power=t(power, torch.float32),
        t_on=t(t_on, torch.int32),
        t_off=t(t_off, torch.int32),
        speed=t(speed, torch.float32),
        order_key=t(okey_g, torch.float32),
        perm=t(perm, torch.int32),
    )
