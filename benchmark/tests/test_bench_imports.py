"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""
import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "smirk_tpu"}


def top_level_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert "smirk_tpu_torch" not in names and not names & FORBIDDEN


def test_the_scan_sees_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import smirk_tpu_torch.kernels\nfrom smirk_tpu.x import y\nimport jaxtyping\n")
    assert set(top_level_imports(f)) == {"smirk_tpu_torch", "smirk_tpu", "jaxtyping"}
    assert set(top_level_imports(f)) & FORBIDDEN == {"smirk_tpu"}
