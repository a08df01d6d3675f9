"""No module of the benchmark imports JAX, flax or the JAX package, and the
plain reference imports nothing of the port: top-level names compared whole
(the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "anytime3d_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "anytime3d_tpu_torch" not in imported_tops(path)


def test_the_check_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import anytime3d_tpu_torch.models\nfrom jax import numpy\nimport flax.linen as nn\n"
                   "from anytime3d_tpu.kernels import conv_k2\n")
    assert imported_tops(src) & FORBIDDEN == {"jax", "flax", "anytime3d_tpu"}
    assert "anytime3d_tpu_torch" in imported_tops(src)
