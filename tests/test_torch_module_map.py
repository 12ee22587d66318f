"""Every module of the JAX reference (``src/repro/``) has a counterpart of
the same path under ``src/repro_torch/``, or stands on the README's "Not
ported, and why" list, so a new reference module cannot go unported
silently. Files are walked by name; neither package is imported."""
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "src", "repro")
PORT = os.path.join(REPO, "src", "repro_torch")


def _modules(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files if f.endswith(".py")]
    return sorted(out)


def _not_ported():
    """The reference paths named on the README's list, and its lines."""
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    section = text.split("### Not ported, and why\n", 1)[1]
    section = re.split(r"\n(?:#+ |Times measured)", section, maxsplit=1)[0]
    paths = re.findall(r"`src/repro/([A-Za-z0-9_/]+\.py)`", section)
    return paths, section


def test_every_reference_module_has_a_counterpart_or_is_listed():
    listed, _ = _not_ported()
    missing = [m for m in _modules(REF)
               if not os.path.exists(os.path.join(PORT, m)) and m not in listed]
    assert missing == [], f"reference modules with no port and not on the list: {missing}"


def test_the_list_names_only_reference_modules_and_the_refused_options():
    listed, section = _not_ported()
    assert listed and all(os.path.exists(os.path.join(REF, m)) for m in listed), listed
    ported = [m for m in listed if os.path.exists(os.path.join(PORT, m))]
    assert ported == [], ported
    assert "item 12c.6" in section


def test_the_walk_sees_both_packages():
    ref, port = _modules(REF), _modules(PORT)
    assert "core/engine.py" in ref and "core/engine.py" in port
    assert "models/transformer.py" in port and "kernels/ssd_scan.py" in port
