"""The port imports neither JAX, the JAX package nor pandas.

An AST scan over every module of ``presto_tpu_torch`` and over
``chip_smoke.py`` finds no ``jax`` / ``presto_tpu`` / ``pandas`` import
(exact top-level name; the card's machine has no pandas), and a fresh
interpreter that imports the whole port has loaded none of them.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch_bridge  # noqa: F401  (pins one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "presto_tpu", "pandas"}
FILES = sorted(
    [p.relative_to(ROOT).as_posix() for p in (ROOT / "presto_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]
)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_scan_covers_the_package():
    assert "presto_tpu_torch/workloads.py" in FILES
    assert "presto_tpu_torch/ops/cuda_q1.py" in FILES
    assert "presto_tpu_torch/ops/cuda_join.py" in FILES
    assert "presto_tpu_torch/ops/hashing.py" in FILES
    assert "presto_tpu_torch/runtime/session.py" in FILES
    assert "presto_tpu_torch/sql/analyzer.py" in FILES
    for mod in ("__init__", "frame", "tpch_oracle", "ssb_oracle", "tpcds_oracle"):
        assert f"presto_tpu_torch/oracle/{mod}.py" in FILES
    assert "chip_smoke.py" in FILES


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_or_reference_imports(rel):
    bad = _imported_roots(ROOT / rel) & FORBIDDEN
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    mods = ["presto_tpu_torch." + p[len("presto_tpu_torch/"):-3].replace("/", ".")
            for p in FILES if p.startswith("presto_tpu_torch/")]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "assert 'jax' not in sys.modules, 'jax was imported'\n"
            + "assert 'presto_tpu' not in sys.modules, 'presto_tpu was imported'\n"
            + "assert 'pandas' not in sys.modules, 'pandas was imported'\n"
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
