"""Nothing in ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name,
compared whole."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "kafkastreams_cep_tpu"}
#: What the reference's side of the check is built from.
REFERENCE = [BENCH / "reference", BENCH / "check.py", BENCH / "query.py",
             BENCH / "traffic" / "generator.py"]


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def files(*roots):
    for r in roots:
        yield from (sorted(r.rglob("*.py")) if r.is_dir() else [r])


@pytest.mark.parametrize("path", list(files(BENCH)), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", list(files(*REFERENCE)), ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert "kafkastreams_cep_tpu_torch" not in names and "torch" not in names


def test_reference_loads_nothing_of_the_program():
    """The reference run in a fresh process: what ``sys.modules`` holds."""
    code = ("import sys; from portbench import check; "
            "from portbench.reference import oracle; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120, check=True)
    loaded = set(eval(p.stdout))
    assert not loaded & (JAX | {"kafkastreams_cep_tpu_torch", "torch"})
