#!/usr/bin/env python
"""port-lint — the invariants of the PyTorch port (``src/repro_torch/``) as
AST passes, beside ``spars_lint.py``, whose passes read the JAX reference
(``src/repro/``) only.

The port keeps its own invariants: it never imports the reference or jax,
its sorts are stable, each of its rules has a twin in its oracle, its
kernel wrappers keep one contract, and every ``SimMetrics`` field reaches
``row()``. This tool checks them, so a slice cannot break one silently.
It reuses ``spars_lint``'s findings, file loading and waivers (by
importing the module) and ``docs_pass`` for the docs.

Passes (each emits ``file:line RULE message``):

* **PL001 isolation** — no ``import jax``, ``jaxlib`` or ``repro``/
  ``repro.*`` anywhere in ``src/repro_torch/**`` or ``chip_smoke.py``,
  imports inside functions included (a subprocess that imports the
  package sees only the imports that run at import time).
* **PL002 sweep-key completeness** (SL001's analogue) — every
  ``cfg.<attr>``/``config.<attr>`` read in the functions reachable from
  ``sweep.sweep``/``sweep_async`` (through ``core/sweep.py`` and the
  engine functions it calls) appears in ``sweep._static_trace_key``, or is
  on :data:`PL002_PER_ROW`, the written list of reads that are per-row
  values or derived from the key. The key drives ``sweep.cache_stats``
  and the service's reuse report.
* **PL003 oracle twins** (SL003's analogue) — the engine's rule functions
  (first parameter ``s``) and the policy rules, single and ``*_rows``, map
  to ``PyDES`` methods in ``core/ref/pydes.py`` by name (modulo the
  written alias and one-sided tables), and every method maps back.
* **PL004 wrapper contract** — each public wrapper in
  ``kernels/{event_fuse,flash_attention,ssd_scan}.py`` (a function that
  counts a launch in ``LAUNCHES``, or has a ``<name>_plain`` twin) has its
  ``<name>_plain`` twin in the module, a zero-size short-circuit, a
  ``device.type == "cpu"`` route to a plain version, a ``LAUNCHES``
  increment, ``_build.refuse_grad`` where an input can require grad
  (:data:`PL004_GRAD_FREE` lists the wrappers whose inputs cannot), and no
  ``try``/``except`` whose handler calls a plain version (no fallback).
* **PL005 port numerics** — every sort in ``core/`` and ``models/moe.py``
  is stable (``torch.sort``/``torch.argsort``/``.sort(``/``.argsort(`` pass
  ``stable=True``; numpy's pass ``kind="stable"``), and every
  ``torch.arange(`` in ``core/`` passes ``dtype=``. The oracle
  (``core/ref/``) sorts Python lists, whose sort is stable, and is skipped.
* **PL006 metrics row** (SL006's analogue) — every field of the port's
  ``SimMetrics`` (``core/types.py``) reaches ``row()``, transitively
  through its helper methods.
* **PL007 docs** — ``docs_pass`` over ``PERF.md`` and the verify skill
  (``CHANGES.md`` stays out: its short historical paths are not links).

SL002 (flag gates) and SL005 (purity of traced bodies) have no analogue:
the port traces nothing. Its ``static_bool`` (``core/policy.py``) sees
concrete Python flags only, and its rules are eager PyTorch, where a host
read is a counted sync (``engine.HOST_SYNCS``), not a tracer leak.

Waive an intentional violation with ``# spars-lint: ignore[PLxxx] <reason>``
on the flagged line, or anywhere in the contiguous comment block directly
above it. Run ``python tools/lint/port_lint.py [--only PLxxx] [--root DIR]``;
it exits 1 on any unwaived finding. Tier-1 runs it through
``tests/test_torch_lint.py``.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
from typing import Iterable, List, Optional, Sequence, Set, Tuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import docs_pass  # noqa: E402
import spars_lint  # noqa: E402
from spars_lint import Finding  # noqa: E402

REPO = spars_lint.REPO

# root-relative locations of the checked files; a fixture tree (tests/
# fixtures/lint_torch/<case>/) overrides the root and holds only the files
# its rule needs — a pass whose files are absent is skipped for that root
PORT = "src/repro_torch"
SMOKE = "chip_smoke.py"
ENGINE = "src/repro_torch/core/engine.py"
SWEEP = "src/repro_torch/core/sweep.py"
POLICY = "src/repro_torch/core/policy.py"
PYDES = "src/repro_torch/core/ref/pydes.py"
TYPES = "src/repro_torch/core/types.py"
KERNELS = tuple(f"src/repro_torch/kernels/{k}.py"
                for k in ("event_fuse", "flash_attention", "ssd_scan"))
DOCS = ("PERF.md", ".claude/skills/verify/SKILL.md")

_load = spars_lint._load
_top_functions = spars_lint._top_functions


def _py_files(root: str, rel_dir: str) -> List[str]:
    """Root-relative paths of the .py files under ``rel_dir``, sorted."""
    out = []
    for d, _, files in os.walk(os.path.join(root, rel_dir)):
        out += [os.path.relpath(os.path.join(d, f), root)
                for f in files if f.endswith(".py")]
    return sorted(out)


# ---------------------------------------------------------------------------
# PL001 — isolation from jax and the reference
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: Optional[str]) -> bool:
    return bool(module) and module.split(".", 1)[0] in FORBIDDEN


def _imported_modules(tree: ast.AST) -> Iterable[Tuple[str, int]]:
    """(module, line) of every import anywhere in ``tree``, including
    ``importlib.import_module("x")`` and ``__import__("x")`` with a literal
    name."""
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                yield a.name, n.lineno
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            yield n.module or "", n.lineno
        elif (isinstance(n, ast.Call) and n.args
              and isinstance(n.args[0], ast.Constant)
              and isinstance(n.args[0].value, str)
              and ((isinstance(n.func, ast.Name) and n.func.id == "__import__")
                   or (isinstance(n.func, ast.Attribute)
                       and n.func.attr == "import_module"))):
            yield n.args[0].value, n.lineno


def check_pl001(root: str) -> List[Finding]:
    out: List[Finding] = []
    rels = _py_files(root, PORT) + ([SMOKE] if os.path.exists(os.path.join(root, SMOKE)) else [])
    for rel in rels:
        f = _load(root, rel)
        for module, line in _imported_modules(f.tree):
            if _forbidden(module) and not f.waived(line, "PL001"):
                out.append(Finding(
                    f.rel, line, "PL001",
                    f"the port imports `{module}` — it must run without jax "
                    "and without the reference package",
                ))
    return out


# ---------------------------------------------------------------------------
# PL002 — sweep-key completeness
# ---------------------------------------------------------------------------

SWEEP_ROOTS = ("sweep", "sweep_async")
KEY_FN = "_static_trace_key"

# config reads reachable from the sweep that are not in its key, each with
# why it is not structure (decided by the reference's SL001 tables: none of
# these is in its _static_trace_key, and each is a traced per-row operand
# of EngineConst there or feeds the key's `cap`)
PL002_PER_ROW = {
    "max_batches": "resolved into the batch cap, which the key holds as `cap`",
    "timeout_or_inf": "the row's timeout, EngineConst.timeout (a per-row value)",
    "forecast_horizon": "the row's horizon, EngineConst.forecast_horizon",
    "forecast_alpha": "the row's EWMA weight, EngineConst.forecast_alpha",
    "rl_decision_interval": "the row's interval, EngineConst.rl_interval",
    "base": "the row's scheduler; its flags are the [E] PolicyParams rows",
    "policy": "the row's power policy; its flags are the [E] PolicyParams "
              "rows (its controller and dvfs arity are in the key)",
    "policy.params": "lowers the row's policy to its [E] PolicyParams flags",
    "policy.horizon": "the Forecast policy's horizon, a per-row value",
    "policy.alpha": "the Forecast policy's EWMA weight, a per-row value",
}


def _imported_names(tree: ast.Module, module: str) -> Set[str]:
    """Names that ``tree`` imports from ``module`` at top level."""
    return {
        a.asname or a.name
        for n in tree.body
        if isinstance(n, ast.ImportFrom) and n.module == module
        for a in n.names
    }


def _attr_calls(fn: ast.AST, base: str) -> Set[str]:
    """``x`` of every ``base.x(...)`` call under ``fn``."""
    return {
        n.func.attr
        for n in ast.walk(fn)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and isinstance(n.func.value, ast.Name) and n.func.value.id == base
    }


def check_pl002(root: str) -> List[Finding]:
    sweep, engine = _load(root, SWEEP), _load(root, ENGINE)
    if sweep is None or engine is None:
        return []
    fs, fe = _top_functions(sweep.tree), _top_functions(engine.tree)
    key_fn = fs.get(KEY_FN)
    if key_fn is None:
        return [Finding(sweep.rel, 1, "PL002", f"sweep key function {KEY_FN}() not found")]
    from_engine = _imported_names(sweep.tree, "repro_torch.core.engine")

    def resolve(fn: ast.AST, in_sweep: bool) -> Set[Tuple[bool, str]]:
        """The (in sweep.py, name) functions that ``fn`` calls: a bare name
        is the module's own function, or in sweep.py an engine import;
        ``engine.x(...)`` is the engine's."""
        out = set()
        for c in spars_lint._called_names(fn):
            if in_sweep and c in fs:
                out.add((True, c))
            elif (not in_sweep or c in from_engine) and c in fe:
                out.add((False, c))
        if in_sweep:
            out |= {(False, c) for c in _attr_calls(fn, "engine") if c in fe}
        return out

    covered = {p for p, _ in spars_lint._cfg_reads(key_fn)}
    for _, helper in resolve(key_fn, True):
        if helper in spars_lint._cfg_call_args(key_fn):
            src = fs if helper in fs else fe
            covered |= {p for p, _ in spars_lint._cfg_reads(src[helper])}

    seen: Set[Tuple[bool, str]] = set()
    todo = [(True, r) for r in SWEEP_ROOTS if r in fs]
    while todo:
        node = todo.pop()
        if node in seen:
            continue
        seen.add(node)
        in_sweep, name = node
        todo.extend(resolve((fs if in_sweep else fe)[name], in_sweep))

    out: List[Finding] = []
    for in_sweep, name in sorted(seen):
        f, fn = (sweep, fs[name]) if in_sweep else (engine, fe[name])
        for path, line in spars_lint._cfg_reads(fn):
            if path in covered or path in PL002_PER_ROW or f.waived(line, "PL002"):
                continue
            out.append(Finding(
                f.rel, line, "PL002",
                f"config read `cfg.{path}` reachable from sweep ({name}) is "
                f"missing from sweep.{KEY_FN} and from port_lint.PL002_PER_ROW "
                "— two grids of different structure would share a cache key",
            ))
    return out


# ---------------------------------------------------------------------------
# PL003 — oracle twins
# ---------------------------------------------------------------------------

# rule name (``_rows`` stripped) -> PyDES method, where the names differ
PL003_ALIASES = {
    "_complete_jobs": "_complete",
    "_complete_transitions": "_transitions",
    "_ready_times": "_ready",
    "accrue_energy": "_accrue",
    "apply_rl_commands": "_apply_rl",
    "effective_node_speed": "_eff_speed",
    "run_sim": "run",
}

# engine and policy rules with no oracle twin by design, each with why
PL003_ENGINE_ONLY = {
    "_queue_window": "window spelling of _scheduler_pass's queue slice",
    "_window_values": "the host read of the window; the oracle reads lists",
    "_pass_inputs": "ready times and the node order a pass shares; the oracle's _sort_key",
    "_run_pass": "loop body shared by the FCFS and EASY attempts of _scheduler_pass",
    "_earliest": "the masked min under the oracle's _next_time",
    "_power_step": "rules 6-10 dispatcher; the oracle inlines it in _process_batch",
    "_time_candidates": "folded into the oracle's _next_time",
    "_next_transition": "folded into the oracle's _next_time",
    "_node_power_draw": "inlined in the oracle's _accrue",
    "_ledger": "the event kernel's dense sums, inlined in the oracle's _accrue",
    "event_horizon": "fused next_time and draw (the event kernel); parity-tested",
    "horizon": "picks the fused or legacy time advance; the oracle has one loop",
    "_quiet_batch": "proven no-op fast path; the oracle has no quiet dispatch",
    "_loop": "the host loop of run_sim and run_sim_gantt",
    "all_done": "inlined in the oracle's run loop",
    "run_sim_gantt": "gantt-recording variant of run_sim",
    "_available": "the unreserved idle or waking node count of rules 6, 7 and 10; "
                  "the oracle sums it inline in each",
    "available": "available_rows: _available over rows",
    "alloc_min_speed": "alloc_min_speed_rows: each job's slowest node; the oracle "
                       "takes the min inline in _start_jobs and _apply_dvfs_modes",
}

# oracle methods with no engine or policy twin by design, each with why
PL003_ORACLE_ONLY = {
    "__init__": "constructor",
    "_partition_select": "host spelling of the engine's _partition_pick "
                         "inside _try_allocate",
    "energy_by_state": "legacy view summed from energy_by_group",
    "_sort_key": "host spelling of the engine's (ready, order_key, nid) argsort",
    "_gantt_mark": "oracle-side gantt recorder; the engine's is run_sim_gantt's log",
    "_eligible": "inlined in the engine as the `node_job < 0` mask",
    "metrics": "the engine's twin is metrics.metrics_from_state",
    "schedule_table": "the engine's twin is metrics.schedule_table",
}


def _norm(name: str) -> str:
    return name.lstrip("_")


def _rule_name(name: str) -> str:
    """A rule's oracle name: ``_rows`` stripped, then the alias table."""
    base = name[: -len("_rows")] if name.endswith("_rows") else name
    return PL003_ALIASES.get(base, base)


def check_pl003(root: str) -> List[Finding]:
    pydes, engine = _load(root, PYDES), _load(root, ENGINE)
    if pydes is None or engine is None:
        return []
    oracle = spars_lint._class_methods(pydes.tree, "PyDES")
    oracle_norm = {_norm(m) for m in oracle}
    rules: List[Tuple[spars_lint._File, ast.FunctionDef]] = []
    for rel in (ENGINE, POLICY):
        f = _load(root, rel)
        if f is None:
            continue
        for fn in _top_functions(f.tree).values():
            args = fn.args.args
            if (args and args[0].arg == "s") or (rel == POLICY and fn.name.endswith("_rows")):
                rules.append((f, fn))

    out: List[Finding] = []
    targets: Set[str] = set()
    for f, fn in rules:
        target = _rule_name(fn.name)
        targets.add(_norm(target))
        base = fn.name[: -len("_rows")] if fn.name.endswith("_rows") else fn.name
        if base in PL003_ENGINE_ONLY or fn.name in PL003_ENGINE_ONLY:
            continue
        if _norm(target) in oracle_norm or f.waived(fn.lineno, "PL003"):
            continue
        out.append(Finding(
            f.rel, fn.lineno, "PL003",
            f"rule `{fn.name}` has no oracle twin (expected PyDES.{target} or "
            "an entry in port_lint.PL003_ALIASES / PL003_ENGINE_ONLY) — "
            "engine/oracle drift",
        ))
    for name, m in oracle.items():
        if name in PL003_ORACLE_ONLY or _norm(name) in targets:
            continue
        if pydes.waived(m.lineno, "PL003"):
            continue
        out.append(Finding(
            pydes.rel, m.lineno, "PL003",
            f"oracle method `PyDES.{name}` has no engine or policy rule twin "
            "(expected a matching s-first or *_rows function, or an entry in "
            "port_lint.PL003_ALIASES / PL003_ORACLE_ONLY) — engine/oracle drift",
        ))
    return out


# ---------------------------------------------------------------------------
# PL004 — kernel wrapper contract
# ---------------------------------------------------------------------------

# wrappers none of whose inputs can require grad, each with why
PL004_GRAD_FREE = {
    "event_fuse_occ": "its inputs are int32 (node arrays, t, group ids)",
}


def _counts_launch(fn: ast.AST) -> bool:
    """``LAUNCHES[...] += ...`` under ``fn``."""
    return any(
        isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Subscript)
        and isinstance(n.target.value, ast.Name) and n.target.value.id == "LAUNCHES"
        for n in ast.walk(fn)
    )


def _calls_refuse_grad(fn: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr == "refuse_grad"
        for n in ast.walk(fn)
    )


def _plain_calls(node: ast.AST) -> List[ast.Call]:
    return [
        n for n in ast.walk(node)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
        and n.func.id.endswith("_plain")
    ]


def _cpu_route(fn: ast.FunctionDef) -> bool:
    """An ``if`` on ``<x>.type == "cpu"`` whose body calls a plain version."""
    for n in ast.walk(fn):
        if not isinstance(n, ast.If):
            continue
        on_cpu = any(
            isinstance(c, ast.Compare) and isinstance(c.left, ast.Attribute)
            and c.left.attr == "type"
            and any(isinstance(x, ast.Constant) and x.value == "cpu" for x in c.comparators)
            for c in ast.walk(n.test)
        )
        if on_cpu and any(_plain_calls(b) for b in n.body):
            return True
    return False


def _fallbacks(fn: ast.AST) -> List[int]:
    """Lines of ``except`` handlers under ``fn`` that call a plain version."""
    return [
        h.lineno
        for n in ast.walk(fn) if isinstance(n, ast.Try)
        for h in n.handlers if any(_plain_calls(b) for b in h.body)
    ]


def check_pl004(root: str) -> List[Finding]:
    out: List[Finding] = []
    for rel in KERNELS:
        f = _load(root, rel)
        if f is None:
            continue
        funcs = _top_functions(f.tree)

        def reach(name: str) -> Set[str]:
            return spars_lint._reachable(funcs, [name])

        for name, fn in sorted(funcs.items()):
            if name.startswith("_") or name.endswith("_plain"):
                continue
            launches = any(_counts_launch(funcs[r]) for r in reach(name))
            if not launches and f"{name}_plain" not in funcs:
                continue
            problems = []
            if f"{name}_plain" not in funcs:
                problems.append(f"no `{name}_plain` twin in the module")
            if not spars_lint._has_zero_size_guard(fn):
                problems.append("no zero-size short-circuit (`== 0` guard returning early)")
            if not _cpu_route(fn):
                problems.append('no `device.type == "cpu"` route to its plain version')
            if not launches:
                problems.append("never counts a launch in `LAUNCHES`")
            if name not in PL004_GRAD_FREE and not any(
                    _calls_refuse_grad(funcs[r]) for r in reach(name)):
                problems.append("no `_build.refuse_grad` for inputs that can require grad")
            if problems and not f.waived(fn.lineno, "PL004"):
                for p in problems:
                    out.append(Finding(f.rel, fn.lineno, "PL004",
                                       f"kernel wrapper `{name}`: {p}"))
            for r in sorted(reach(name)):
                for line in _fallbacks(funcs[r]):
                    if not f.waived(line, "PL004"):
                        out.append(Finding(
                            f.rel, line, "PL004",
                            f"kernel wrapper `{name}` falls back to a plain "
                            f"version in an `except` ({r}) — a CUDA tensor "
                            "launches the kernel or raises",
                        ))
    return sorted(set(out))


# ---------------------------------------------------------------------------
# PL005 — port numerics
# ---------------------------------------------------------------------------

NUMERICS = ("src/repro_torch/core", "src/repro_torch/models/moe.py")
ARANGE_DIRS = ("src/repro_torch/core",)
# skipped, with why
PL005_SKIP = {
    "src/repro_torch/core/ref/": "the oracle sorts Python lists (always stable) "
                                 "and uses no torch",
}
_NP = {"np", "numpy"}


def _kw(call: ast.Call, name: str):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_const(node, *values) -> bool:
    return isinstance(node, ast.Constant) and node.value in values


def _numerics_files(root: str) -> List[str]:
    rels: List[str] = []
    for rel in NUMERICS:
        if rel.endswith(".py"):
            rels += [rel] if os.path.exists(os.path.join(root, rel)) else []
        else:
            rels += _py_files(root, rel)
    return [r for r in rels if not any(r.startswith(s) for s in PL005_SKIP)]


def check_pl005(root: str) -> List[Finding]:
    out: List[Finding] = []
    for rel in _numerics_files(root):
        f = _load(root, rel)
        for n in ast.walk(f.tree):
            if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)):
                continue
            recv = n.func.value.id if isinstance(n.func.value, ast.Name) else None
            msg = None
            if n.func.attr in ("sort", "argsort"):
                if recv in _NP:
                    if not _is_const(_kw(n, "kind"), "stable", "mergesort"):
                        msg = f'`np.{n.func.attr}` without kind="stable"'
                elif not _is_const(_kw(n, "stable"), True):
                    what = f"torch.{n.func.attr}" if recv == "torch" else f".{n.func.attr}("
                    msg = (f"`{what}` without stable=True — ties would order "
                           "differently from the reference and the oracle")
            elif (n.func.attr == "arange" and recv == "torch"
                  and any(rel.startswith(d) for d in ARANGE_DIRS)
                  and _kw(n, "dtype") is None):
                msg = "`torch.arange(` without dtype= — the engine's indices are typed"
            if msg and not f.waived(n.lineno, "PL005"):
                out.append(Finding(f.rel, n.lineno, "PL005", msg))
    return out


# ---------------------------------------------------------------------------
# PL006 — SimMetrics field / row() consistency
# ---------------------------------------------------------------------------

def check_pl006(root: str) -> List[Finding]:
    f = _load(root, TYPES)
    if f is None:
        return []
    cls = next((n for n in f.tree.body
                if isinstance(n, ast.ClassDef) and n.name == "SimMetrics"), None)
    if cls is None:
        return []
    fields = [(s.target.id, s.lineno) for s in cls.body
              if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]
    methods = {m.name: m for m in cls.body if isinstance(m, ast.FunctionDef)}
    if "row" not in methods:
        return [Finding(f.rel, cls.lineno, "PL006", "SimMetrics has no row() method")]
    used: Set[str] = set()
    todo, seen = ["row"], set()
    while todo:
        name = todo.pop()
        if name in seen or name not in methods:
            continue
        seen.add(name)
        for n in ast.walk(methods[name]):
            if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                    and n.value.id == "self"):
                used.add(n.attr)
                todo.append(n.attr)
    return [
        Finding(f.rel, line, "PL006",
                f"SimMetrics field `{name}` never reaches row() — a metric "
                "without its column (or dead weight)")
        for name, line in fields
        if name not in used and not f.waived(line, "PL006")
    ]


# ---------------------------------------------------------------------------
# PL007 — docs hygiene
# ---------------------------------------------------------------------------

def check_pl007(root: str) -> List[Finding]:
    out: List[Finding] = []
    for problem in docs_pass.collect(docs=DOCS, root=root):
        doc, _, msg = problem.partition(": ")
        out.append(Finding(doc, 1, "PL007", msg or problem))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

PASSES = (
    ("PL001", "isolation from jax and the reference", check_pl001),
    ("PL002", "sweep-key completeness", check_pl002),
    ("PL003", "oracle twins", check_pl003),
    ("PL004", "kernel wrapper contract", check_pl004),
    ("PL005", "port numerics", check_pl005),
    ("PL006", "metrics-row consistency", check_pl006),
    ("PL007", "docs hygiene", check_pl007),
)

RULE_IDS = tuple(rule for rule, _, _ in PASSES)


def run_passes(root: str = REPO, only: Optional[Sequence[str]] = None) -> List[Finding]:
    selected = set(only) if only else set(RULE_IDS)
    unknown = selected - set(RULE_IDS)
    if unknown:
        raise SystemExit(
            f"port-lint: unknown rule(s) {sorted(unknown)}; known: {', '.join(RULE_IDS)}"
        )
    findings: List[Finding] = []
    for rule, _, fn in PASSES:
        if rule in selected:
            findings.extend(fn(root))
    return sorted(findings)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="port-lint",
        description="invariants of the PyTorch port (PL001-PL007)",
    )
    p.add_argument("--root", default=REPO,
                   help="tree to check (default: this repo; tests point it at "
                   "seeded-violation fixtures)")
    p.add_argument("--only", default=None,
                   help="comma-separated rule ids to run (e.g. PL001,PL004); default: all")
    p.add_argument("--list", action="store_true", help="list rules and exit")
    args = p.parse_args(argv)
    if args.list:
        for rule, title, _ in PASSES:
            print(f"{rule}  {title}")
        return 0
    only = args.only.split(",") if args.only else None
    findings = run_passes(root=os.path.abspath(args.root), only=only)
    for x in findings:
        print(x.render(), file=sys.stderr)
    if findings:
        print(f"port-lint: {len(findings)} finding(s) (waive intentional ones with "
              "`# spars-lint: ignore[PLxxx] <reason>`)", file=sys.stderr)
        return 1
    print(f"port-lint: {len(only) if only else len(PASSES)} pass(es) clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
