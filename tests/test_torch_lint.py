"""port-lint lane (``tools/lint/port_lint.py``): the port's linter catches
every seeded violation class and names its rule, honours waivers, finds
the clean fixture clean and the live tree clean, and its CLI exits 1 on a
finding and 0 on a clean tree. AST only: nothing is imported from either
package, so the file takes seconds.
"""
import os
import subprocess
import sys

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", "tools", "lint"))

import port_lint  # noqa: E402
import spars_lint  # noqa: E402

FIXTURES = os.path.join(_HERE, "fixtures", "lint_torch")
SCRIPT = os.path.join(port_lint.REPO, "tools", "lint", "port_lint.py")
# fixture trees carry only source files, never the docs, so the docs pass
# (PL007) runs against the live tree only
CODE_RULES = [r for r in port_lint.RULE_IDS if r != "PL007"]


def _run(case, only):
    return port_lint.run_passes(root=os.path.join(FIXTURES, case), only=only)


@pytest.mark.parametrize("rule", CODE_RULES)
def test_seeded_violation_fires_and_names_its_rule(rule):
    findings = _run(rule.lower(), [rule])
    assert findings, f"{rule} fixture produced no findings"
    assert all(f.rule == rule and f.line > 0 and f.file for f in findings)
    assert all(f.render().split(" ", 2)[1] == rule for f in findings)


@pytest.mark.parametrize("rule", CODE_RULES)
def test_each_fixture_fires_only_its_own_rule(rule):
    """A seeded tree breaks one invariant, so the other passes stay quiet
    on it: each rule's findings come from its own fixture only."""
    others = [r for r in CODE_RULES if r != rule]
    assert _run(rule.lower(), others) == []


def test_pl001_sees_imports_inside_functions_and_by_name():
    text = "\n".join(f.render() for f in _run("pl001", ["PL001"]))
    assert "leak.py:5 PL001" in text and "`jax.numpy`" in text  # inside a function
    assert "`repro.core`" in text
    assert "chip_smoke.py:5 PL001" in text and "`jaxlib`" in text  # importlib.import_module


def test_pl002_names_reads_in_the_sweep_and_in_the_engine():
    findings = _run("pl002", ["PL002"])
    text = "\n".join(f.msg for f in findings)
    assert "cfg.shiny`" in text and "cfg.shinier_tables`" in text
    assert {f.file for f in findings} == {
        "src/repro_torch/core/sweep.py", "src/repro_torch/core/engine.py"}
    assert "_static_trace_key" in text


def test_pl003_checks_both_directions_and_the_rows_rules():
    text = "\n".join(f.msg for f in _run("pl003", ["PL003"]))
    assert "`apply_budget`" in text and "PyDES.apply_budget" in text
    assert "`ration_rows`" in text and "PyDES.ration" in text  # _rows stripped
    assert "`PyDES._lonely`" in text


def test_pl004_flags_every_half_of_the_contract():
    text = "\n".join(f.msg for f in _run("pl004", ["PL004"]))
    for part in ("no `twice_plain` twin", "zero-size", 'device.type == "cpu"',
                 "refuse_grad", "falls back to a plain version in an `except`"):
        assert part in text, part


def test_pl005_flags_torch_numpy_and_method_sorts_and_the_arange():
    findings = _run("pl005", ["PL005"])
    text = "\n".join(f.msg for f in findings)
    for part in ("`torch.argsort`", "`.sort(`", "`np.argsort`", "`torch.sort`",
                 "`torch.arange(`"):
        assert part in text, part
    assert len(findings) == 5


def test_pl006_names_the_field():
    findings = _run("pl006", ["PL006"])
    assert [f.msg.split("`")[1] for f in findings] == ["peak_power_w"]


def test_waivers_silence_their_lines():
    """``ignore[PLxxx]`` on the line or in the comment block above it, and
    a comma list, keep the whole waived tree clean."""
    assert _run("waived", CODE_RULES) == []
    f = spars_lint._File(os.path.join(FIXTURES, "waived"), "src/repro_torch/core/engine.py")
    assert f.waived(6, "PL005") and not f.waived(6, "PL001")


def test_clean_fixture_is_clean():
    assert _run("clean", CODE_RULES) == []


def test_live_tree_is_clean():
    """All seven passes over this repo."""
    findings = port_lint.run_passes()
    assert not findings, "\n".join(f.render() for f in findings)


def test_every_per_row_and_one_sided_entry_is_used():
    """No stale entry in the written tables: each per-row read is read
    from the sweep, and each one-sided name names a live function."""
    saved = dict(port_lint.PL002_PER_ROW)
    port_lint.PL002_PER_ROW.clear()
    try:
        unkeyed = {f.msg.split("`cfg.")[1].split("`")[0]
                   for f in port_lint.check_pl002(port_lint.REPO)}
    finally:
        port_lint.PL002_PER_ROW.update(saved)
    assert unkeyed == set(saved)
    engine = spars_lint._load(port_lint.REPO, port_lint.ENGINE)
    policy = spars_lint._load(port_lint.REPO, port_lint.POLICY)
    pydes = spars_lint._load(port_lint.REPO, port_lint.PYDES)
    names = set(spars_lint._top_functions(engine.tree)) | {
        n[: -len("_rows")] if n.endswith("_rows") else n
        for n in spars_lint._top_functions(policy.tree)}
    assert set(port_lint.PL003_ENGINE_ONLY) <= names
    assert set(port_lint.PL003_ORACLE_ONLY) <= set(
        spars_lint._class_methods(pydes.tree, "PyDES"))


def test_cli_exit_codes():
    bad = subprocess.run(
        [sys.executable, SCRIPT, "--root", os.path.join(FIXTURES, "pl004"),
         "--only", "PL004"], capture_output=True, text=True)
    assert bad.returncode == 1 and "PL004" in bad.stderr
    good = subprocess.run(
        [sys.executable, SCRIPT, "--root", os.path.join(FIXTURES, "clean"),
         "--only", ",".join(CODE_RULES)], capture_output=True, text=True)
    assert good.returncode == 0, good.stderr
    live = subprocess.run([sys.executable, SCRIPT], capture_output=True, text=True)
    assert live.returncode == 0 and "7 pass(es) clean" in live.stdout, live.stderr


def test_unknown_rule_rejected():
    with pytest.raises(SystemExit):
        port_lint.run_passes(only=["PL999"])
