"""No module the benchmark or its reference loads is JAX or the JAX
package (top-level names compared whole: ``repro_torch`` is the port),
and the reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from port_bench import bench

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in bench.BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & BANNED, path


def test_reference_imports_nothing_of_the_program():
    for path in (bench.BENCH_DIR / "reference").rglob("*.py"):
        assert not _imports(path) & (BANNED | {"repro_torch"}), path


def test_a_run_loads_no_jax():
    """A whole run of every cell, in a fresh process."""
    code = (
        "import sys\n"
        "from port_bench.tests import cells\n"
        "from port_bench import bench\n"
        "for name in cells.CELLS:\n"
        "    assert cells.run(name, seconds=0.1, trace=True)['correct']\n"
        "ref = [m for m in sys.modules if m.startswith('port_bench.ref')]\n"
        "assert ref, 'the reference was not loaded'\n"
        "print('forbidden:', bench.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden: []"
