"""The port stands alone: no module of gerris_tpu_torch/ and not
chip_smoke.py imports jax or the JAX package, gerris_tpu (parsed, not
run: every import statement, at any depth)."""
import ast
import os

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "gerris_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "gerris_tpu_torch")):
        out += [os.path.join(d, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    """The top-level names of every absolute import in ``path``."""
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return [n.split(".")[0] for n in names]


def test_the_sources_are_found():
    srcs = _sources()
    assert len(srcs) > 30
    assert any(p.endswith("models/amr_ns.py") for p in srcs)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [n for n in _imported(path) if n in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
