"""Platform model — the paper's ``platform.json`` (§2.3.1, Table 3).

A platform describes the simulated HPC machine: node count, per-state power
draw, state-transition delays, and (schema-level) DVFS profiles. The paper's
illustrative configuration (Table 3) is exposed as :data:`DEFAULT_PLATFORM`:

    active 190 W · idle 190 W · sleep 9 W
    switch-on  190 W for 30 min · switch-off 9 W for 45 min

Heterogeneous machines (mixed partitions, staggered hardware generations,
big.LITTLE-style islands) are described as an ordered tuple of
:class:`NodeGroup` entries; node ids are assigned contiguously in group
order. The homogeneous case keeps the flat scalar fields, and the per-node
table accessors (:meth:`PlatformSpec.node_power_table` and friends)
broadcast them, so both cases feed the engines through one code path
(core/SEMANTICS.md §Heterogeneity).

DVFS is modelled at two levels. The *static* level predates runtime DVFS:
``dvfs_profiles`` + ``dvfs_mode`` pin one operating point for a whole run
(the engine then just uses the node's operating ``speed``). The *runtime*
level (core/SEMANTICS.md §DVFS) gives every node group a small mode table —
:meth:`NodeGroup.dvfs_modes`, or the document-level ``dvfs_profiles`` for a
homogeneous machine — of absolute ``(speed, active-watts)`` operating
points; a DVFS-enabled power policy switches each group's mode while the
simulation runs. :meth:`PlatformSpec.group_dvfs_tables` lowers the schema
to the ``[G, M]`` tables both engines consume.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# Node power-state encoding shared by the Python oracle and the JAX engine.
# Order matters: the engine indexes power/legality tables by these values.
SLEEP = 0
SWITCHING_ON = 1
IDLE = 2
ACTIVE = 3
SWITCHING_OFF = 4
N_STATES = 5

STATE_NAMES = ("sleep", "switching_on", "idle", "active", "switching_off")


@dataclasses.dataclass(frozen=True)
class DvfsProfile:
    """One DVFS operating point: active power draw (W) and absolute speed.

    Used statically (``PlatformSpec.dvfs_mode`` pins one profile for a whole
    run) and as a runtime mode-table entry (``NodeGroup.dvfs_modes`` /
    document-level ``dvfs_profiles`` — see core/SEMANTICS.md §DVFS).
    """

    name: str
    power: float
    speed: float = 1.0

    def __post_init__(self):
        if self.speed <= 0:
            raise ValueError(
                f"DvfsProfile.speed must be positive, got {self.speed}"
            )
        if self.power <= 0:
            raise ValueError(
                f"DvfsProfile.power must be positive, got {self.power}"
            )


def _validate_modes(modes, where: str) -> None:
    names = [p.name for p in modes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate DVFS mode names in {where}: {names}")


@dataclasses.dataclass(frozen=True)
class NodeGroup:
    """A contiguous block of identical nodes inside a heterogeneous platform.

    ``speed`` is the group's operating compute speed (realized wall time of a
    job = nominal runtime / min speed over its allocated nodes — see
    core/SEMANTICS.md §Heterogeneity). ``dvfs_modes`` is the group's runtime
    DVFS mode table — absolute (speed, active-watts) operating points a
    DVFS-enabled power policy switches between at runtime (SEMANTICS.md
    §DVFS); empty means the single base operating point
    ``(speed, power_active)``.
    """

    count: int
    name: str = "default"
    power_active: float = 190.0
    power_idle: float = 190.0
    power_sleep: float = 9.0
    power_switch_on: float = 190.0
    power_switch_off: float = 9.0
    t_switch_on: int = 30 * 60
    t_switch_off: int = 45 * 60
    speed: float = 1.0
    dvfs_modes: Tuple[DvfsProfile, ...] = ()

    def __post_init__(self):
        if self.count <= 0:
            raise ValueError(f"NodeGroup.count must be positive, got {self.count}")
        if self.speed <= 0:
            raise ValueError(f"NodeGroup.speed must be positive, got {self.speed}")
        object.__setattr__(self, "dvfs_modes", tuple(self.dvfs_modes))
        _validate_modes(self.dvfs_modes, f"node group {self.name!r}")

    def power_table(self) -> Tuple[float, ...]:
        return (
            self.power_sleep,
            self.power_switch_on,
            self.power_idle,
            self.power_active,
            self.power_switch_off,
        )

    def to_json(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "count": self.count,
            "compute_speed": self.speed,
            "states": {
                "sleep": {"power": self.power_sleep},
                "idle": {"power": self.power_idle},
                "active": {"power": self.power_active},
                "switching_on": {
                    "power": self.power_switch_on,
                    "transition_time": self.t_switch_on,
                },
                "switching_off": {
                    "power": self.power_switch_off,
                    "transition_time": self.t_switch_off,
                },
            },
        }
        if self.dvfs_modes:
            out["dvfs_modes"] = [
                dataclasses.asdict(p) for p in self.dvfs_modes
            ]
        return out


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """Hardware description of the simulated machine.

    Attributes mirror the paper's platform JSON. The scalar fields describe a
    homogeneous machine; ``node_groups`` (when non-empty) describes a
    heterogeneous one and takes precedence — the scalar fields then only act
    as defaults mirrored from the first group. Node ids run contiguously in
    group order.
    """

    nb_nodes: int
    power_active: float = 190.0
    power_idle: float = 190.0
    power_sleep: float = 9.0
    power_switch_on: float = 190.0
    power_switch_off: float = 9.0
    t_switch_on: int = 30 * 60  # seconds (paper: 30 minutes)
    t_switch_off: int = 45 * 60  # seconds (paper: 45 minutes)
    compute_speed: float = 1.0
    dvfs_profiles: tuple = ()
    dvfs_mode: Optional[str] = None
    node_groups: Tuple[NodeGroup, ...] = ()

    def __post_init__(self):
        if self.compute_speed <= 0:
            raise ValueError(
                f"compute_speed must be positive, got {self.compute_speed}"
            )
        object.__setattr__(self, "dvfs_profiles", tuple(self.dvfs_profiles))
        _validate_modes(self.dvfs_profiles, "platform dvfs_profiles")
        if self.dvfs_mode is not None:
            names = [p.name for p in self.dvfs_profiles]
            if self.dvfs_mode not in names:
                from repro_torch.core.types import did_you_mean

                raise ValueError(
                    f"unknown DVFS mode {self.dvfs_mode!r}; this platform "
                    f"declares {names or 'no dvfs_profiles'}"
                    + did_you_mean(self.dvfs_mode, names)
                )
        if self.node_groups:
            object.__setattr__(self, "node_groups", tuple(self.node_groups))
            total = sum(g.count for g in self.node_groups)
            if total != self.nb_nodes:
                raise ValueError(
                    f"node_groups cover {total} nodes != nb_nodes {self.nb_nodes}"
                )
            # keep the legacy scalar views mirrored from the first group on
            # every construction path (not just platform_from_groups), so
            # legacy callers never see defaults that disagree with the
            # per-node tables the engines actually simulate
            g0 = self.node_groups[0]
            object.__setattr__(self, "power_active", g0.power_active)
            object.__setattr__(self, "power_idle", g0.power_idle)
            object.__setattr__(self, "power_sleep", g0.power_sleep)
            object.__setattr__(self, "power_switch_on", g0.power_switch_on)
            object.__setattr__(self, "power_switch_off", g0.power_switch_off)
            object.__setattr__(self, "t_switch_on", g0.t_switch_on)
            object.__setattr__(self, "t_switch_off", g0.t_switch_off)
            object.__setattr__(self, "compute_speed", g0.speed)

    # ---- group views -----------------------------------------------------
    @property
    def is_heterogeneous(self) -> bool:
        return len(self.node_groups) > 1

    def groups(self) -> Tuple[NodeGroup, ...]:
        """Group view; a homogeneous spec synthesizes one group from scalars."""
        if self.node_groups:
            return self.node_groups
        return (
            NodeGroup(
                count=self.nb_nodes,
                power_active=self.power_active,
                power_idle=self.power_idle,
                power_sleep=self.power_sleep,
                power_switch_on=self.power_switch_on,
                power_switch_off=self.power_switch_off,
                t_switch_on=self.t_switch_on,
                t_switch_off=self.t_switch_off,
                speed=self.speed(),
                # document-level profiles are the synthesized group's runtime
                # mode table — a homogeneous machine with dvfs_profiles can
                # run a DVFS-enabled policy directly
                dvfs_modes=self.dvfs_profiles,
            ),
        )

    def n_groups(self) -> int:
        return len(self.groups())

    def group_names(self) -> Tuple[str, ...]:
        return tuple(g.name for g in self.groups())

    # ---- per-node tables (the engines' native representation) ------------
    def node_group_id(self) -> np.ndarray:
        """i32[N] group index of every node (contiguous in group order)."""
        return np.repeat(
            np.arange(len(self.groups()), dtype=np.int32),
            [g.count for g in self.groups()],
        )

    def node_power_table(self) -> np.ndarray:
        """f32[N, 5] per-node per-state watts."""
        return np.repeat(
            np.asarray([g.power_table() for g in self.groups()], np.float32),
            [g.count for g in self.groups()],
            axis=0,
        )

    def node_t_switch_on(self) -> np.ndarray:
        """i32[N] per-node switch-on delay (s)."""
        return np.repeat(
            np.asarray([g.t_switch_on for g in self.groups()], np.int32),
            [g.count for g in self.groups()],
        )

    def node_t_switch_off(self) -> np.ndarray:
        """i32[N] per-node switch-off delay (s)."""
        return np.repeat(
            np.asarray([g.t_switch_off for g in self.groups()], np.int32),
            [g.count for g in self.groups()],
        )

    def node_speed(self) -> np.ndarray:
        """f32[N] per-node compute speed (realized runtime = work / speed)."""
        return np.repeat(
            np.asarray([g.speed for g in self.groups()], np.float32),
            [g.count for g in self.groups()],
        )

    def node_order_key(self) -> np.ndarray:
        """f32[N] allocation preference key: active watts per unit of work.

        Lower is better ("cheap/fast first"); computed in float32 so the JAX
        engine and the Python oracle order nodes identically
        (core/SEMANTICS.md §Heterogeneity).
        """
        table = self.node_power_table()
        return (table[:, ACTIVE] / self.node_speed()).astype(np.float32)

    def group_active_powers(self) -> Tuple[float, ...]:
        return tuple(g.power_active for g in self.groups())

    # ---- runtime DVFS mode tables (core/SEMANTICS.md §DVFS) ---------------
    def group_dvfs_modes(self) -> Tuple[Tuple[DvfsProfile, ...], ...]:
        """Each group's mode table, sorted ascending by speed (index 0 is
        the slowest mode — the heuristic ladder's idle point). A group with
        no declared modes gets the single base operating point."""
        out = []
        for g in self.groups():
            modes = g.dvfs_modes or (
                DvfsProfile("base", power=g.power_active, speed=g.speed),
            )
            out.append(tuple(sorted(modes, key=lambda p: (p.speed, p.name))))
        return tuple(out)

    def n_dvfs_modes(self) -> int:
        """Mode-table width M (max modes over groups; >= 1). M is a shape:
        platforms in one sweep must agree on it."""
        return max(len(t) for t in self.group_dvfs_modes())

    def group_dvfs_tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(f32[G, M] speed, f32[G, M] active watts, i32[G] mode counts).

        Groups with fewer than M modes pad by repeating their last (fastest)
        entry; the per-group count clamps mode selection so the padding is
        never chosen. Mode 0's entries equal the group's base (speed,
        power_active) when no modes are declared — that identity is the
        metamorphic single-mode guarantee (§DVFS).
        """
        tabs = self.group_dvfs_modes()
        G, M = len(tabs), self.n_dvfs_modes()
        speed = np.ones((G, M), np.float32)
        watts = np.zeros((G, M), np.float32)
        n = np.zeros(G, np.int32)
        for gi, t in enumerate(tabs):
            n[gi] = len(t)
            for mi in range(M):
                p = t[min(mi, len(t) - 1)]
                speed[gi, mi] = np.float32(p.speed)
                watts[gi, mi] = np.float32(p.power)
        return speed, watts, n

    # ---- legacy scalar views ---------------------------------------------
    def power_table(self):
        """Per-state power draw indexed by the state encoding above."""
        return (
            self.power_sleep,
            self.power_switch_on,
            self.power_idle,
            self.power_active,
            self.power_switch_off,
        )

    def speed(self) -> float:
        if self.dvfs_mode:
            for p in self.dvfs_profiles:
                if p.name == self.dvfs_mode:
                    return p.speed
        return self.compute_speed

    def to_json(self) -> Dict[str, Any]:
        out = {
            "nb_nodes": self.nb_nodes,
            "compute_speed": self.compute_speed,
            "dvfs_mode": self.dvfs_mode,
            "dvfs_profiles": [dataclasses.asdict(p) for p in self.dvfs_profiles],
            "states": {
                "sleep": {"power": self.power_sleep},
                "idle": {"power": self.power_idle},
                "active": {"power": self.power_active},
                "switching_on": {
                    "power": self.power_switch_on,
                    "transition_time": self.t_switch_on,
                },
                "switching_off": {
                    "power": self.power_switch_off,
                    "transition_time": self.t_switch_off,
                },
            },
            "transitions": [
                {"from": "sleep", "to": "switching_on"},
                {"from": "switching_on", "to": "idle"},
                {"from": "idle", "to": "active"},
                {"from": "active", "to": "idle"},
                {"from": "idle", "to": "switching_off"},
                {"from": "switching_off", "to": "sleep"},
            ],
        }
        if self.node_groups:
            out["node_groups"] = [g.to_json() for g in self.node_groups]
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)


def make_platform(nb_nodes: int, **kw) -> PlatformSpec:
    return PlatformSpec(nb_nodes=nb_nodes, **kw)


def platform_from_groups(groups: Sequence[NodeGroup], **kw) -> PlatformSpec:
    """Build a PlatformSpec from node groups (nb_nodes derived).

    A single group collapses to the equivalent scalar (homogeneous) spec so
    that "N identical nodes" and "one machine of N nodes" are literally the
    same object — the metamorphic guarantee tests rely on.
    """
    groups = tuple(groups)
    if not groups:
        raise ValueError("platform_from_groups needs at least one group")
    if len(groups) == 1:
        g = groups[0]
        if g.dvfs_modes:
            # the collapsed scalar spec keeps the group's runtime mode table
            # as its document-level profiles (groups() round-trips them)
            kw = {**kw, "dvfs_profiles": g.dvfs_modes}
        return PlatformSpec(
            nb_nodes=g.count,
            power_active=g.power_active,
            power_idle=g.power_idle,
            power_sleep=g.power_sleep,
            power_switch_on=g.power_switch_on,
            power_switch_off=g.power_switch_off,
            t_switch_on=g.t_switch_on,
            t_switch_off=g.t_switch_off,
            compute_speed=g.speed,
            **kw,
        )
    # __post_init__ mirrors the scalar views from the first group
    return PlatformSpec(
        nb_nodes=sum(g.count for g in groups),
        node_groups=groups,
        **kw,
    )


def _states_from_json(
    states: Mapping[str, Any], defaults: Mapping[str, float]
) -> Dict[str, Any]:
    def p(name, default):
        return float(states.get(name, {}).get("power", default))

    def t(name, default):
        return int(states.get(name, {}).get("transition_time", default))

    active = p("active", defaults["power_active"])
    return {
        "power_active": active,
        # idle inherits the document-level idle like every other state; only
        # when the document doesn't set one does it default to this entry's
        # active draw (the paper's idle==active illustrative setup)
        "power_idle": p("idle", defaults.get("power_idle", active)),
        "power_sleep": p("sleep", defaults["power_sleep"]),
        "power_switch_on": p("switching_on", defaults["power_switch_on"]),
        "power_switch_off": p("switching_off", defaults["power_switch_off"]),
        "t_switch_on": t("switching_on", defaults["t_switch_on"]),
        "t_switch_off": t("switching_off", defaults["t_switch_off"]),
    }


_DEFAULTS = {
    "power_active": 190.0,
    "power_sleep": 9.0,
    "power_switch_on": 190.0,
    "power_switch_off": 9.0,
    "t_switch_on": 1800,
    "t_switch_off": 2700,
}


def _group_from_json(
    d: Mapping[str, Any],
    defaults: Mapping[str, float],
    index: int,
    count: int,
    default_speed: float = 1.0,
) -> NodeGroup:
    fields = _states_from_json(d.get("states", {}), defaults)
    modes = tuple(
        DvfsProfile(m["name"], float(m["power"]), float(m.get("speed", 1.0)))
        for m in d.get("dvfs_modes", [])
    )
    return NodeGroup(
        count=count,
        name=str(d.get("name", f"group{index}")),
        speed=float(d.get("compute_speed", d.get("speed", default_speed))),
        dvfs_modes=modes,
        **fields,
    )


def _coalesce_nodes(entries: List[NodeGroup]) -> Tuple[NodeGroup, ...]:
    """Merge consecutive per-node entries that are identical up to the name.

    The JSON loader *preserves* per-node heterogeneity, but N identical
    entries collapse into one group of N so a homogeneous platform written
    node-by-node is indistinguishable from its scalar form (metamorphic
    guarantee; also keeps the engine's group axis small).
    """
    out: List[NodeGroup] = []
    for g in entries:
        if out and dataclasses.replace(
            out[-1], count=g.count, name=g.name
        ) == g:
            out[-1] = dataclasses.replace(
                out[-1], count=out[-1].count + g.count
            )
        else:
            out.append(g)
    return tuple(out)


def _from_json(obj: Mapping[str, Any]) -> PlatformSpec:
    profiles = tuple(
        DvfsProfile(d["name"], float(d["power"]), float(d.get("speed", 1.0)))
        for d in obj.get("dvfs_profiles", [])
    )
    top = _states_from_json(obj.get("states", {}), _DEFAULTS)
    common = dict(
        dvfs_profiles=profiles,
        dvfs_mode=obj.get("dvfs_mode"),
    )

    # document-level compute_speed is the default for every group/node entry,
    # matching the homogeneous loader's semantics
    default_speed = float(obj.get("compute_speed", 1.0))
    group_defaults = {**_DEFAULTS, **top}
    if "idle" not in obj.get("states", {}):
        # only an *explicit* document idle inherits into groups; otherwise an
        # entry's idle defaults to its own active draw (paper idle==active)
        group_defaults.pop("power_idle", None)
    groups: List[NodeGroup] = []
    if "node_groups" in obj:
        for i, d in enumerate(obj["node_groups"]):
            groups.append(
                _group_from_json(
                    d, group_defaults, i, int(d["count"]), default_speed
                )
            )
    elif "nodes" in obj:
        # per-node entries (the paper schema's per-node form) are preserved,
        # with identical neighbours coalesced into groups
        for i, d in enumerate(obj["nodes"]):
            groups.append(
                _group_from_json(
                    d, group_defaults, i, int(d.get("count", 1)),
                    default_speed,
                )
            )
        groups = list(_coalesce_nodes(groups))

    if groups:
        spec = platform_from_groups(tuple(groups), **common)
        if "nb_nodes" in obj and int(obj["nb_nodes"]) != spec.nb_nodes:
            raise ValueError(
                f"nb_nodes {obj['nb_nodes']} != nodes described {spec.nb_nodes}"
            )
        return spec

    return PlatformSpec(
        nb_nodes=int(obj["nb_nodes"]),
        compute_speed=float(obj.get("compute_speed", 1.0)),
        **top,
        **common,
    )


def load_platform(path_or_obj) -> PlatformSpec:
    """Load a platform from a JSON file path or a parsed dict.

    Accepts three schema forms: flat scalar ``states`` (homogeneous),
    ``node_groups`` (list of {name, count, states, compute_speed}), and
    ``nodes`` (one entry per node; identical neighbours are coalesced but
    distinct per-node entries are preserved — never silently collapsed).
    """
    if isinstance(path_or_obj, Mapping):
        return _from_json(path_or_obj)
    with open(path_or_obj) as f:
        return _from_json(json.load(f))


def mixed_platform_example(nb_nodes: int = 16) -> PlatformSpec:
    """Canonical 3-group heterogeneous example used by tests and benchmarks.

    fast: hot 2x-speed nodes · eco: cool 0.5x nodes · std: paper Table 3.
    Different idle/sleep watts, asymmetric transition delays, 2x/0.5x/1x
    speeds — one third of the machine each (remainder to std).
    """
    a = nb_nodes // 3
    b = nb_nodes // 3
    return platform_from_groups(
        (
            NodeGroup(count=a, name="fast", power_active=300.0,
                      power_idle=250.0, power_sleep=12.0,
                      power_switch_on=300.0, power_switch_off=12.0,
                      t_switch_on=600, t_switch_off=900, speed=2.0),
            NodeGroup(count=b, name="eco", power_active=100.0,
                      power_idle=80.0, power_sleep=4.0,
                      power_switch_on=100.0, power_switch_off=4.0,
                      t_switch_on=120, t_switch_off=180, speed=0.5),
            NodeGroup(count=nb_nodes - a - b, name="std"),
        )
    )


def dvfs_platform_example(nb_nodes: int = 16) -> PlatformSpec:
    """Canonical runtime-DVFS example: the mixed 3-group platform with a
    (slow/base/turbo) mode table on each group (core/SEMANTICS.md §DVFS).

    Mode speeds bracket each group's base speed; mode watts scale roughly
    with speed so turbo trades energy for wall time. Used by tests and
    ``benchmarks/bench_dvfs.py``.
    """

    def ladder(base_speed: float, base_watts: float) -> Tuple[DvfsProfile, ...]:
        return (
            DvfsProfile("slow", power=0.6 * base_watts, speed=0.5 * base_speed),
            DvfsProfile("base", power=base_watts, speed=base_speed),
            DvfsProfile("turbo", power=1.5 * base_watts, speed=1.5 * base_speed),
        )

    mixed = mixed_platform_example(nb_nodes)
    return platform_from_groups(
        tuple(
            dataclasses.replace(g, dvfs_modes=ladder(g.speed, g.power_active))
            for g in mixed.groups()
        )
    )


def curie_platform(nb_nodes: int = 11_200) -> PlatformSpec:
    """CEA Curie-class 3-group platform preset (the paper's large-scale
    benchmark machine: 11 200 nodes).

    Mirrors Curie's real partition structure — thin (the bulk), hybrid
    (accelerated, faster and hotter), large (fat memory nodes) — with
    paper-Table-3-class power numbers scaled per partition. Group counts
    split ~82/16/2 percent and always sum to ``nb_nodes``, so smaller
    verify-scale instances keep all three groups (minimum 3 nodes).
    G = 3 regardless of N is exactly the regime the group-indexed tables
    (core/SEMANTICS.md §Group-indexed tables) are built for.
    """
    if nb_nodes < 3:
        raise ValueError(
            f"curie_platform needs >= 3 nodes (one per partition), "
            f"got {nb_nodes}"
        )
    thin = max(1, (nb_nodes * 82) // 100)
    hybrid = max(1, (nb_nodes * 16) // 100)
    if thin + hybrid >= nb_nodes:
        thin, hybrid = nb_nodes - 2, 1
    large = nb_nodes - thin - hybrid
    return platform_from_groups(
        (
            NodeGroup(count=thin, name="thin"),
            NodeGroup(count=hybrid, name="hybrid", power_active=280.0,
                      power_idle=220.0, power_sleep=11.0,
                      power_switch_on=280.0, power_switch_off=11.0,
                      t_switch_on=20 * 60, t_switch_off=30 * 60, speed=1.6),
            NodeGroup(count=large, name="large", power_active=420.0,
                      power_idle=330.0, power_sleep=18.0,
                      power_switch_on=420.0, power_switch_off=18.0,
                      t_switch_on=45 * 60, t_switch_off=60 * 60, speed=1.2),
        )
    )


# Paper Table 3 (power model); node count chosen per workload trace.
DEFAULT_PLATFORM = PlatformSpec(nb_nodes=128)
