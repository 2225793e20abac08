"""No module the benchmark loads imports JAX or the JAX package, compared
by whole top-level name (the port's package name begins with the JAX
package's), and the reference imports nothing of the port either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.lib import harness, manifest

BENCH = manifest.BENCH_DIR
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "smartedgesensor3dhumanpose_tpu"}
PORT = "smartedgesensor3dhumanpose_tpu_torch"


def imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", sources(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import_in_the_benchmark(path):
    assert not imported_top_levels(path) & JAX_SIDE


@pytest.mark.parametrize("path", sources(BENCH / "reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported_top_levels(path)
    assert not names & (JAX_SIDE | {PORT})
    assert names <= {"__future__", "dataclasses", "typing", "collections", "numpy", "torch",
                     "portbench", "functools", "math", "hashlib", "json"}


def test_whole_names_are_compared():
    before = dict(sys.modules)
    try:
        sys.modules.pop("smartedgesensor3dhumanpose_tpu", None)
        sys.modules[PORT + "_probe"] = sys
        assert "smartedgesensor3dhumanpose_tpu" not in harness.forbidden_loaded()
        sys.modules["smartedgesensor3dhumanpose_tpu.fusion"] = sys
        assert harness.forbidden_loaded() == ["smartedgesensor3dhumanpose_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_a_run_loads_no_jax():
    """Every module a run loads (the harness, both drivers, the port, the
    readers, the counts and the reference), by a tiny run of each driver in
    a fresh process."""
    code = (
        "import sys, json\n"
        "from portbench.tests import tiny\n"
        "tiny.run('live'); tiny.run('offline')\n"
        "from portbench.lib import manifest\n"
        "for m in manifest.load_manifest()['per_layer']: manifest.metric_reader(m['name'])\n"
        "for k in ('K1', 'K2', 'K3', 'L1'): manifest.kernel_count(k)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=600, env={"PYTHONPATH": str(manifest.ROOT),
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded and "portbench" in loaded
    assert not loaded & JAX_SIDE
