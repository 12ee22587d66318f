"""Single-run workload/platform resolvers — the part of the reference's
``experiments/spec.py`` that ``launch/sim.py`` needs.

The declarative ``Experiment`` grid spec rides on the batched sweep, which a
later slice of the port brings (ROADMAP Queue 1 items 8-9). SWF trace replay
and the model-training ``profiles`` workload are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.workloads.generator import PRESETS, GeneratorConfig, generate_workload
from repro_torch.workloads.platform import PlatformSpec, load_platform
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


def resolve_workload(spec, replication: int = 0) -> Workload:
    """Workload from a declarative spec.

    * ``"preset:<name>"`` — a seeded generator preset,
    * ``{"preset": <name>, ...GeneratorConfig overrides}`` — preset with
      overrides (e.g. ``n_jobs``),
    * ``{...GeneratorConfig fields}`` — a full generator config,
    * a path to a workload JSON file, or an in-memory :class:`Workload`.

    ``replication`` offsets the generator seed (replication r uses
    ``seed + r``); file-backed and in-memory workloads reject r > 0.
    """
    if (isinstance(spec, str) and spec.startswith("swf:")) or (
        isinstance(spec, Mapping) and "swf" in spec
    ):
        raise NotImplementedError(
            "SWF trace replay is not ported yet (ROADMAP Queue 1 item 6)"
        )
    if spec == "profiles":
        raise NotImplementedError(
            "the 'profiles' workload is not ported yet (ROADMAP Queue 1 "
            "item 12)"
        )
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
