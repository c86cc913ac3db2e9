"""Nothing the benchmark runs imports the JAX stack or the JAX package
``repro`` (top-level module names compared whole: ``repro_torch`` is not
``repro``), and the plain references import nothing of the program."""
import ast

from portbench.lib import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module)
    return {m.split(".")[0] for m in out}


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(harness.BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imports(path) & FORBIDDEN, path


def test_references_import_nothing_of_the_program():
    for path in sorted((harness.BENCH / "reference").glob("*.py")):
        assert "repro_torch" not in _imports(path), path


def test_the_runtime_check_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch.core", "numpy", "reprox"]) == []
    assert harness.forbidden_modules(["repro.models", "jaxlib.xla", "jax"]) == [
        "jax", "jaxlib", "repro"]
