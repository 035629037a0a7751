"""Nothing under portbench/ imports JAX or the JAX package, and the plain
references import nothing of the program either. Each import's top-level
name, the part before the first dot, is compared whole: the program's
package name begins with the JAX package's."""
import ast
import sys

import pytest

from portbench import run, spec

FOLDER = spec.HERE
JAX = {"jax", "jaxlib", "flax", "kangaroo_tpu"}


def _imports(path):
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


SOURCES = sorted(p for p in FOLDER.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(FOLDER).as_posix())
def test_no_jax_import(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((FOLDER / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "numpy", "torch"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kangaroo_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kangaroo_tpu.stereo", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "kangaroo_tpu"]


def test_the_program_and_the_harness_load_no_jax():
    """The drivers' imports of the program leave JAX out of the process (a
    fresh interpreter: this one may hold JAX from other tests)."""
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); from portbench import run, spec, trace;"
            "[spec.driver(e) for e in ('sgm_batched', 'mvs_keyframe')];"
            "import kangaroo_tpu_torch.apps.stereo, kangaroo_tpu_torch.apps.stereo_sgm;"
            "print(run.forbidden_modules())" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
