"""The port's public names against the JAX reference's (ROADMAP item 18).

Both trees are read with ``ast``; neither package is imported for that, as
``tests/test_torch_module_map.py`` walks the files. Three things hold,
modulo the written tables below, each entry with its reason (the README's
"Public names" section mirrors them):

1. for every module that both packages have, the reference's top-level
   public names are names of the port's module (a lazily exported name,
   ``_EXPORTS`` or a module ``__getattr__``'s names, and a submodule count);
2. every ``__all__`` of a reference ``__init__`` is covered by the port's;
3. every ``from repro.X import Y`` in ``examples/`` and ``benchmarks/``
   resolves to ``repro_torch.X`` having ``Y``.

Then, on the CPU: the package names run a 16-node simulation equal to
``engine.simulate``'s, and ``engine.sweep`` equals ``sweep.sweep`` row for
row; importing ``repro_torch.core`` imports neither jax nor ``repro``.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "src", "repro")
PORT = os.path.join(REPO, "src", "repro_torch")

_MODULE_API = ("the reference's functional init/apply API over parameter pytrees; "
               "the port's layers are nn.Modules that hold their parameters")

# reference module -> {public name the port does not have: why}
DIFFERENCES = {
    "models/layers.py": {
        "AttnParams": _MODULE_API + " (`Attention`)",
        "attn_init": _MODULE_API + " (`Attention`)",
        "attn_apply": _MODULE_API + " (`Attention.forward`)",
        "attn_qkv": _MODULE_API + " (`Attention.forward` computes q, k and v)",
        "swiglu_init": _MODULE_API + " (`SwiGLU`)",
        "swiglu_apply": _MODULE_API + " (`SwiGLU.forward`)",
        "gelu_mlp_init": _MODULE_API + " (`GeluMLP`)",
        "gelu_mlp_apply": _MODULE_API + " (`GeluMLP.forward`)",
        "layer_norm": "unused by the reference's models; not ported",
        "attention_chunked": "the reference's XLA twin of the flash kernel is the "
                             "port's `\"chunked\"` attention impl, which takes the kernel",
        "DEFAULT_CHUNK": "the chunk of `attention_chunked`, which the port has not",
    },
    "models/ssm.py": {
        "gla_scan_reference": "the sequential oracle is `kernels/ssd_scan.py::gla_scan_plain`",
        **{f"{block}_{fn}": _MODULE_API + f" (`{cls}`)"
           for block, cls in (("mamba2", "Mamba2"), ("mlstm", "MLstm"), ("slstm", "SLstm"))
           for fn in ("init", "apply", "decode")},
    },
    "models/moe.py": {
        "moe_init": _MODULE_API + " (`MoE`)",
        "moe_apply": _MODULE_API + " (`MoE.forward`)",
        "moe_apply_reference": "the dense oracle is `models/moe.py::moe_reference`",
    },
    "models/transformer.py": {
        "Model": _MODULE_API + " (`Transformer`, from `build_model`)",
        "block_init": _MODULE_API + " (each block type's nn.Module)",
        "block_apply": _MODULE_API + " (each block's `forward`)",
        "block_cache": _MODULE_API + " (`Transformer.init_cache`)",
        "PyTree": "a typing alias of the pytree API; the port passes tensors and modules",
    },
    "models/__init__.py": {
        "Model": _MODULE_API + " (`Transformer`, from `build_model`)",
    },
    "training/compression.py": {"PyTree": "a typing alias of the pytree API"},
    "training/optimizer.py": {"PyTree": "a typing alias of the pytree API"},
    "training/train_step.py": {"PyTree": "a typing alias of the pytree API"},
    "kernels/event_fuse.py": {
        "LANES": "the TPU's 128-lane tiling of the Pallas kernel; the CUDA kernel tiles "
                 "by 16-byte quads",
        "PAD_STATE": "the Pallas kernel pads rows to its tiling; the CUDA kernel masks "
                     "the ragged tail",
    },
    "kernels/flash_attention.py": {
        "LANES": "the TPU's 128-lane tiling of the Pallas kernel",
        "NEG_INF": "the masked logit, a literal -1e30 in the port's kernels and plain version",
    },
    "launch/mesh.py": {
        "ICI_BW_PER_LINK": "the TPU's inter-chip link; the port's collective term is "
                           "`NVLINK_BW` (0 on one card)",
    },
}

# reference name that is a function, a module of the same name in the port
MODULE_NOT_FUNCTION = {
    "core/__init__.py": {
        "sweep": "`repro_torch.core.sweep` is the sweep's module; the function is "
                 "`sweep.sweep`, also `engine.sweep`",
    },
    "kernels/__init__.py": {
        name: f"`repro_torch.kernels.{name}` is the module of the wrapper "
              f"`{name}.{name}`, its plain version and its launch counts"
        for name in ("flash_attention", "ssd_scan", "event_fuse")
    },
}

# reference modules an example or benchmark imports that the port has not
NOT_PORTED = {
    "kernels/ref.py": "the plain references live beside each port kernel (`*_plain`)",
    "kernels/ops.py": "the dispatch lives in each port kernel module",
}


# ---------------------------------------------------------------------------
# reading the trees
# ---------------------------------------------------------------------------

def _modules(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files if f.endswith(".py")]
    return sorted(out)


def _tree(root, rel):
    with open(os.path.join(root, rel)) as f:
        return ast.parse(f.read(), filename=rel)


def _top_statements(tree):
    """Top-level statements, with the bodies of top-level if/try blocks."""
    todo = list(tree.body)
    while todo:
        n = todo.pop(0)
        yield n
        if isinstance(n, ast.If):
            todo += n.body + n.orelse
        elif isinstance(n, ast.Try):
            todo += n.body + n.orelse + n.finalbody + [b for h in n.handlers for b in h.body]


def _strings(node):
    return [e.value for e in getattr(node, "elts", []) if isinstance(e, ast.Constant)]


def _bound(tree, imports):
    """(names bound at top level, the ``__all__`` list or None)."""
    names, all_ = set(), None
    for n in _top_statements(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                names |= {x.id for x in ast.walk(t) if isinstance(x, ast.Name)}
                if isinstance(t, ast.Name) and t.id == "__all__":
                    all_ = _strings(n.value)
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
        elif imports and isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return names, all_


def _lazy(tree):
    """Names a module ``__getattr__`` serves: the keys of ``_EXPORTS`` or the
    strings of a ``_*_NAMES`` tuple, when the module defines ``__getattr__``."""
    if not any(isinstance(n, ast.FunctionDef) and n.name == "__getattr__" for n in tree.body):
        return set()
    out = set()
    for n in tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0], ast.Name):
            name = n.targets[0].id
            if name == "_EXPORTS" and isinstance(n.value, ast.Dict):
                out |= {k.value for k in n.value.keys if isinstance(k, ast.Constant)}
            elif name.startswith("_") and name.endswith("_NAMES"):
                out |= set(_strings(n.value))
    return out


def _submodules(root, rel):
    if os.path.basename(rel) != "__init__.py":
        return set()
    d = os.path.join(root, os.path.dirname(rel))
    return {f[:-3] for f in os.listdir(d) if f.endswith(".py") and f != "__init__.py"} | {
        f for f in os.listdir(d) if os.path.exists(os.path.join(d, f, "__init__.py"))}


def ref_public(rel):
    """The reference module's public names: its ``__all__``; else, for an
    ``__init__``, the names it binds; else the names it defines."""
    init = os.path.basename(rel) == "__init__.py"
    names, all_ = _bound(_tree(REF, rel), imports=init)
    if all_ is not None:
        return set(all_)
    return {n for n in names if not n.startswith("_")}


def port_names(rel, submodules=True):
    tree = _tree(PORT, rel)
    names, _ = _bound(tree, imports=True)
    names |= _lazy(tree)
    if submodules:
        names |= _submodules(PORT, rel)
    return names


def _not_ported_list():
    """The reference paths on the README's "Not ported, and why" list."""
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    section = text.split("### Not ported, and why\n", 1)[1]
    section = re.split(r"\n(?:#+ |Times measured)", section, maxsplit=1)[0]
    return re.findall(r"`src/repro/([A-Za-z0-9_/]+\.py)`", section)


def _public_names_section():
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    return re.split(r"\n#+ ", text.split("### Public names\n", 1)[1], maxsplit=1)[0]


COMMON = [m for m in _modules(REF) if os.path.exists(os.path.join(PORT, m))]
REF_INITS = [m for m in COMMON if os.path.basename(m) == "__init__.py"
             and _bound(_tree(REF, m), imports=True)[1] is not None]
USERS = sorted(os.path.join(d, f) for d in ("examples", "benchmarks")
               for f in os.listdir(os.path.join(REPO, d)) if f.endswith(".py"))


# ---------------------------------------------------------------------------
# 1-3: the names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", COMMON)
def test_reference_public_names_are_the_ports(rel):
    missing = ref_public(rel) - port_names(rel) - set(DIFFERENCES.get(rel, {}))
    assert not missing, f"{rel}: the port lacks {sorted(missing)} (and no written difference)"


@pytest.mark.parametrize("rel", REF_INITS)
def test_every_reference_all_is_covered(rel):
    want = set(_bound(_tree(REF, rel), imports=True)[1])
    plain = port_names(rel, submodules=False)
    as_module = set(MODULE_NOT_FUNCTION.get(rel, {}))
    missing = want - plain - as_module - set(DIFFERENCES.get(rel, {}))
    assert not missing, f"{rel}: the port's __init__ lacks {sorted(missing)}"
    assert as_module <= _submodules(PORT, rel)


def _resolves(module, name):
    """None if ``from repro.<module> import <name>`` has a port twin or a
    written difference, else what is wrong."""
    parts = module.split(".")[1:]
    rel = "/".join(parts)
    mod = (f"{rel}/__init__.py" if os.path.isdir(os.path.join(REF, rel)) else f"{rel}.py")
    if not os.path.exists(os.path.join(REF, mod)):
        return f"repro.{'.'.join(parts)} is no reference module"
    sub = f"{rel}/{name}.py"
    if os.path.exists(os.path.join(REF, sub)):  # a submodule
        if os.path.exists(os.path.join(PORT, sub)) or sub in NOT_PORTED:
            return None
        return f"the port has no {sub}"
    if not os.path.exists(os.path.join(PORT, mod)):
        return None if mod in NOT_PORTED else f"the port has no {mod}"
    if name in port_names(mod) or name in DIFFERENCES.get(mod, {}):
        return None
    return f"repro_torch.{'.'.join(parts)} has no {name}"


@pytest.mark.parametrize("path", USERS)
def test_examples_and_benchmarks_imports_resolve_in_the_port(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    wrong = [
        f"line {n.lineno}: {why}"
        for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module
        and n.module.split(".")[0] == "repro" and n.module != "repro"
        for a in n.names
        for why in [_resolves(n.module, a.name)] if why
    ]
    assert not wrong, wrong


def test_the_walk_sees_the_imports():
    """The resolver is not vacuous: it names a missing name and module."""
    assert _resolves("repro.core.engine", "no_such_name")
    assert _resolves("repro.models.sharding", "anything")
    assert _resolves("repro.core.engine", "sweep") is None  # engine.__getattr__
    assert _resolves("repro.kernels", "ref") is None  # on NOT_PORTED
    assert len(USERS) >= 10 and len(COMMON) >= 60 and "core/__init__.py" in REF_INITS


def test_every_written_difference_is_live():
    """No stale entry: each names a public reference name the port lacks,
    a reference module the port has not, or a function that is a module."""
    for rel, names in DIFFERENCES.items():
        assert os.path.exists(os.path.join(REF, rel)), rel
        port = port_names(rel) if os.path.exists(os.path.join(PORT, rel)) else set()
        for name in names:
            assert name in ref_public(rel) and name not in port, (rel, name)
    for rel, names in MODULE_NOT_FUNCTION.items():
        for name in names:
            imported = {a.name for n in _tree(REF, rel).body
                        if isinstance(n, ast.ImportFrom) for a in n.names}
            assert name in ref_public(rel) and name in imported, (rel, name)
            assert name in _submodules(PORT, rel) and name not in port_names(rel, False)
    listed = _not_ported_list()
    for rel in NOT_PORTED:
        assert rel in listed and not os.path.exists(os.path.join(PORT, rel)), rel


def test_the_readme_mirrors_the_tables():
    section = _public_names_section()
    for table in (DIFFERENCES, MODULE_NOT_FUNCTION, NOT_PORTED):
        for rel in table:
            assert f"`{rel}`" in section, rel
    assert "engine.sweep" in section and "repro_torch.core.sweep" in section


# ---------------------------------------------------------------------------
# the names at work, on the CPU
# ---------------------------------------------------------------------------

def test_importing_core_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, types\n"
        "import repro_torch.core as core\n"
        "from repro_torch.core import sweep, simulate, EngineConfig, SimBatch\n"
        "from repro_torch.core import engine\n"
        "from repro_torch import kernels, training\n"
        "from repro_torch.kernels import event_fuse\n"
        "assert isinstance(sweep, types.ModuleType) and sweep.__name__ == 'repro_torch.core.sweep'\n"
        "assert engine.sweep is sweep.sweep and engine.SimBatch is SimBatch is sweep.SimBatch\n"
        "assert callable(training.adamw) and isinstance(event_fuse, types.ModuleType)\n"
        "assert sorted(set(core.__all__)) == sorted(core.__all__) and 'sweep' not in core.__all__\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr


def test_core_names_cover_the_references_all():
    import repro_torch.core as core

    want = ref_public("core/__init__.py") - set(MODULE_NOT_FUNCTION["core/__init__.py"])
    assert want <= set(core.__all__)
    for name in core.__all__:
        assert getattr(core, name) is not None
    with pytest.raises(AttributeError):
        core.no_such_name  # noqa: B018


def _small():
    from repro_torch.workloads.generator import GeneratorConfig, generate_workload
    from repro_torch.workloads.platform import PlatformSpec

    return PlatformSpec(nb_nodes=16), generate_workload(GeneratorConfig(n_jobs=30, nb_res=16, seed=3))


def test_package_names_run_the_engines_simulation():
    import numpy as np

    from repro_torch.core import EngineConfig, from_label, schedule_table, simulate
    from repro_torch.core import engine, metrics

    plat, wl = _small()
    base, pol = from_label("EASY PSAS")
    cfg = EngineConfig(base=base, policy=pol, timeout=300)
    got = simulate(plat, wl, cfg, device="cpu")
    want = engine.simulate(plat, wl, cfg, device="cpu")
    table = schedule_table(got)
    assert table.shape[0] == len(wl) and (table >= -1).all()
    np.testing.assert_array_equal(table, metrics.schedule_table(want))
    assert float(got.energy.sum()) == float(want.energy.sum())


def test_engine_sweep_is_the_sweep_row_for_row():
    from repro_torch.core import EngineConfig, engine, sweep

    plat, wl = _small()
    grid = ["FCFS PSUS", {"scheduler": "EASY PSAS+IPM", "timeout": 600}]
    sweep.clear_cache()
    got = engine.sweep(plat, wl, grid, EngineConfig(timeout=300), device="cpu")
    want = sweep.sweep(plat, wl, grid, EngineConfig(timeout=300), device="cpu")
    assert isinstance(got, engine.SimBatch) and len(got) == 2
    assert got.rows() == want.rows()
    assert got.cache_hit is False and want.cache_hit is True  # one key, one LRU
    assert engine.cache_stats() == sweep.cache_stats()
