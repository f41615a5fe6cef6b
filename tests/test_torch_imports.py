"""Import hygiene of the port: nothing under src/repro_torch/ and nothing
in chip_smoke.py imports JAX or the JAX package `repro` (the module
`repro` or `repro.*`; `repro_torch` is the port itself). Every module of
the port imports on a machine without nvcc or a card."""
import ast
import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _forbidden(name: str) -> bool:
    top = name.split(".", 1)[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_rule_matches_prefix_exactly():
    assert _forbidden("repro") and _forbidden("repro.models.layers")
    assert _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.models.layers")
    assert not _forbidden("reprox")


def test_every_port_module_imports_without_a_card():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        importlib.import_module(".".join(parts))
