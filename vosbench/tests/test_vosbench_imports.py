"""The benchmark measures the PyTorch port alone: no module under
`vosbench/` imports JAX, jaxlib, flax or the JAX package, and the
reference imports nothing of the port either. Top-level module names are
compared whole, since the port's name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "slowfast_vos_tpu"}
PORT = "slowfast_vos_tpu_torch"


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_top_levels(path)


def test_the_check_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import slowfast_vos_tpu_torch.models\nfrom slowfast_vos_tpu.models import x\n"
                     "import jaxtyping\nimport importlib\nimportlib.import_module('flax.linen')\n")
    assert imported_top_levels(probe) & FORBIDDEN == {"slowfast_vos_tpu", "flax"}


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from vosbench import run

    monkeypatch.setitem(sys.modules, "slowfast_vos_tpu_torch", types.ModuleType("slowfast_vos_tpu_torch"))
    assert "slowfast_vos_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    assert "jaxlib" in run.forbidden_modules()
