"""The frozen :class:`Experiment` spec, its JSON round-trip and the
workload/platform resolvers — the counterpart of the reference's
``experiments/spec.py``.

The spec is declarative: every field is a JSON value (or a tuple of them),
so ``to_json``/``from_json`` round-trip losslessly and a spec file fully
reproduces a study (seeded generators, pinned grids). It has no device
field: a spec's JSON is the reference's for the same study, and where it
runs is the runner's argument. The resolvers are the single spelling shared
by the experiment runner and ``launch/sim.py``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Optional, Tuple, Union

from repro_torch.workloads.generator import PRESETS, GeneratorConfig, generate_workload
from repro_torch.workloads.platform import PlatformSpec, load_platform
from repro_torch.workloads.traces import replay_workload
from repro_torch.workloads.workload import Workload, load_workload


def check_unknown_keys(keys, known, where: str) -> None:
    """Reject unknown config keys loudly (with a did-you-mean hint) instead
    of silently ignoring typos."""
    unknown = sorted(set(keys) - set(known))
    if not unknown:
        return
    import difflib

    hints = []
    for k in unknown:
        close = difflib.get_close_matches(str(k), sorted(known), n=1)
        hints.append(
            f"{k!r}" + (f" (did you mean {close[0]!r}?)" if close else "")
        )
    raise ValueError(
        f"unknown {where} key(s): {', '.join(hints)}; "
        f"known keys: {', '.join(sorted(known))}"
    )


def check_workload_keys(spec: Mapping) -> None:
    """Fail fast (with a did-you-mean hint) on typo'd generator-override
    keys in a mapping workload spec."""
    known = {f.name for f in dataclasses.fields(GeneratorConfig)} | {"preset"}
    check_unknown_keys(spec, known, "workload spec")


_KNOWN_SWF_KEYS = {
    "swf", "nb_nodes", "procs_per_node", "oversize", "max_jobs", "rebase",
}


def _no_replications(spec, replication: int) -> None:
    if replication:
        raise ValueError(
            f"workload spec {spec!r} is a trace replay; replications "
            "require a preset/generator spec (the seed is the "
            "replicate axis)"
        )


def resolve_workload(spec, replication: int = 0) -> Workload:
    """Workload from a declarative spec.

    * ``"preset:<name>"`` — a seeded generator preset,
    * ``{"preset": <name>, ...GeneratorConfig overrides}`` — preset with
      overrides (e.g. ``n_jobs``),
    * ``{...GeneratorConfig fields}`` — a full generator config,
    * ``"swf:<path>"`` — SWF trace replay with the default adaptation
      (``traces.replay_workload``: platform sized from the trace header,
      submit times rebased to 0),
    * ``{"swf": <path>, ...replay_workload kwargs}`` — replay with
      explicit ``nb_nodes``/``procs_per_node``/``oversize``/``max_jobs``/
      ``rebase``,
    * ``"profiles"`` — the model-training job-profile workload
      (``configs/job_profiles.py``),
    * a path to a workload JSON file, or an in-memory :class:`Workload`.

    ``replication`` offsets the generator seed (replication r uses
    ``seed + r``); file-backed, trace-replay and in-memory workloads reject
    r > 0.
    """
    if isinstance(spec, str) and spec.startswith("swf:"):
        _no_replications(spec, replication)
        return replay_workload(spec.split(":", 1)[1])
    if isinstance(spec, Mapping) and "swf" in spec:
        _no_replications(spec, replication)
        check_unknown_keys(spec, _KNOWN_SWF_KEYS, "swf workload spec")
        kw = dict(spec)
        return replay_workload(kw.pop("swf"), **kw)
    gcfg = None
    if isinstance(spec, str) and spec.startswith("preset:"):
        gcfg = PRESETS[spec.split(":", 1)[1]]
    elif isinstance(spec, Mapping):
        check_workload_keys(spec)
        over = dict(spec)
        base = PRESETS[over.pop("preset")] if "preset" in over else GeneratorConfig()
        gcfg = dataclasses.replace(base, **over)
    if gcfg is not None:
        if replication:
            gcfg = dataclasses.replace(gcfg, seed=gcfg.seed + replication)
        return generate_workload(gcfg)
    if replication:
        raise ValueError(
            f"workload spec {spec!r} is not seeded-generated; replications "
            "require a preset/generator spec (the seed is the replicate axis)"
        )
    if isinstance(spec, Workload):
        return spec
    if spec == "profiles":
        from repro_torch.configs.job_profiles import profile_workload

        return profile_workload()
    return load_workload(spec)


def resolve_platform(spec) -> PlatformSpec:
    """Platform from a declarative spec: an int node count, a platform JSON
    path or parsed dict (homogeneous / node_groups / per-node schemas), or
    an in-memory :class:`PlatformSpec`."""
    if isinstance(spec, PlatformSpec):
        return spec
    if isinstance(spec, int):
        return PlatformSpec(nb_nodes=spec)
    return load_platform(spec)


_KNOWN_RL_KEYS = {"checkpoint", "decision_interval"}


@dataclasses.dataclass(frozen=True)
class Experiment:
    """A declarative, reproducible grid study (JSON-round-trippable).

    The grid is the cross product ``schedulers x timeouts [x forecasts]
    [x platforms]``, run as one batched sweep per replication
    (``core/sweep.py``: the policy flags, timeouts, forecast horizons and
    platform tables are per-row values of one ``[E]`` grid). Scheduler
    labels come from ``policy.from_label``; a timeout of ``None`` means
    "never switch off".

    ``platforms`` is an optional *named* platform axis: a mapping
    ``{name: resolve_platform spec}`` (or a sequence of ``(name, spec)``
    pairs). When set, every grid point additionally carries a platform name
    and the base ``platform`` field is only the sweep's shape anchor —
    every axis entry must share its node/group counts and DVFS mode-table
    width. Rows gain a ``platform`` column.

    ``rl`` attaches a checkpointed controller to RL scheduler labels:
    ``{"checkpoint": <dir saved by training.checkpoint.save_policy>,
    "decision_interval": <s>}`` — the same block ``launch/sim.py`` takes.
    The controller is the sweep config's, shared by the whole grid, so all
    RL labels in one experiment must name the same policy stack; non-RL
    rows run with rule 8 gated off, unaffected.
    """

    name: str
    workload: Union[str, dict]  # resolve_workload spec
    platform: Union[str, int, dict]  # resolve_platform spec
    schedulers: Tuple[str, ...] = ("EASY PSUS",)
    timeouts: Tuple[Optional[int], ...] = (None,)
    # optional forecast-horizon axis (rule 10): seconds of look-ahead for the
    # EWMA predictor, a per-row value of the sweep. (None,) keeps the grid
    # forecast-free; entries only bite on ``+Forecast`` labels — on any
    # other stack the rule is gated off regardless of horizon.
    forecasts: Tuple[Optional[int], ...] = (None,)
    forecast_alpha: float = 0.25  # shared EWMA smoothing weight in [0, 1]
    platforms: Tuple = ()  # optional named platform axis ((name, spec), ...)
    rl: Optional[dict] = None  # {"checkpoint": dir, "decision_interval": s}
    node_order: str = "id"  # "id" | "cheap" | "idle-watts" | "pack"
    # "any" | "partition": "partition" forbids cross-group allocations — a
    # job takes the earliest-completing single group that fits it, or fails
    # to start
    allocation: str = "any"
    terminate_overrun: bool = False
    window: int = 32  # scheduler scan window
    # engine-structure knobs shared by the whole grid like node_order/window
    grouped_tables: bool = False
    merge_bursts: bool = False
    replications: int = 1  # generator-seed replicates (seed, seed+1, ...)
    out: Optional[str] = None  # output dir for metrics.json / rows.csv

    def __post_init__(self):
        # normalize JSON lists to tuples so specs hash and compare stably
        object.__setattr__(self, "schedulers", tuple(self.schedulers))
        object.__setattr__(self, "timeouts", tuple(self.timeouts))
        object.__setattr__(self, "forecasts", tuple(self.forecasts))
        object.__setattr__(self, "platforms", self._norm_platforms())
        if not self.schedulers or not self.timeouts:
            raise ValueError("experiment grid needs >= 1 scheduler and timeout")
        if not self.forecasts:
            raise ValueError(
                "forecasts axis cannot be empty; use (None,) for no axis"
            )
        for fh in self.forecasts:
            if fh is not None and (not isinstance(fh, int) or fh < 0):
                raise ValueError(
                    f"forecast horizon entries must be None or ints >= 0, "
                    f"got {fh!r}"
                )
        if self.replications < 1:
            raise ValueError("replications must be >= 1")
        from repro_torch.core.policy import from_label

        for label in self.schedulers:
            from_label(label)  # fail fast on unknown labels
        if isinstance(self.workload, Mapping):
            # fail fast on typo'd keys (swf replay specs have their own set)
            if "swf" in self.workload:
                check_unknown_keys(
                    self.workload, _KNOWN_SWF_KEYS, "swf workload spec"
                )
            else:
                check_workload_keys(self.workload)
        if self.rl is not None:
            check_unknown_keys(self.rl, _KNOWN_RL_KEYS, "experiment rl")

    def _norm_platforms(self) -> Tuple:
        """Normalize the platform axis to ((name, json-able spec), ...)."""
        entries = self.platforms
        if isinstance(entries, Mapping):
            entries = tuple(entries.items())
        out = []
        for e in entries:
            if isinstance(e, str) or not hasattr(e, "__len__") or len(e) != 2:
                raise ValueError(
                    f"platform-axis entry {e!r} is not a (name, spec) pair "
                    "(pass a mapping {name: spec} or a pair sequence)"
                )
            name, spec = e
            if isinstance(spec, PlatformSpec):
                spec = spec.to_json()  # keep the spec JSON-round-trippable
            out.append((str(name), spec))
        names = [n for n, _ in out]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate platform-axis names: {names}")
        return tuple(out)

    # ---- grid ----
    def grid(self):
        """The declarative grid points, in row order (scheduler-major, then
        timeout, then forecast horizon, then platform-axis entry). The
        runner swaps each point's platform *name* for the resolved
        :class:`PlatformSpec` (and the ``forecast`` key for the row's
        ``forecast_horizon`` value) before handing the scenarios to the
        sweep. A trivial ``(None,)`` forecasts axis adds no ``forecast``
        key, so forecast-free grids keep their row shape."""
        plats = [name for name, _ in self.platforms] or [None]
        return [
            {"scheduler": s, "timeout": t, **(
                {"forecast": fh} if fh is not None else {}
            ), **(
                {"platform": p} if p is not None else {}
            )}
            for s in self.schedulers
            for t in self.timeouts
            for fh in self.forecasts
            for p in plats
        ]

    def engine_config(self):
        """The shared EngineConfig (every grid point is a row over it)."""
        from repro_torch.core.types import EngineConfig

        return EngineConfig(
            node_order=self.node_order,
            allocation=self.allocation,
            terminate_overrun=self.terminate_overrun,
            window=self.window,
            grouped_tables=self.grouped_tables,
            merge_bursts=self.merge_bursts,
            forecast_alpha=self.forecast_alpha,
        )

    # ---- JSON round-trip ----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Experiment":
        obj = json.loads(text)
        if not isinstance(obj, Mapping):
            raise ValueError("experiment JSON must be an object")
        check_unknown_keys(
            obj, {f.name for f in dataclasses.fields(cls)}, "experiment"
        )
        return cls(**obj)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "Experiment":
        with open(path) as f:
            return cls.from_json(f.read())
