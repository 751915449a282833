"""Nothing a run loads is JAX or the JAX package (compared by the whole
top-level name), and the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from rover_bench.harness import registry
from rover_bench.harness.runner import FORBIDDEN

SPEC = registry.benchmark()
PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from rover_bench.tests.tiny import run_tiny
from rover_bench.harness.runner import loaded_forbidden
out = run_tiny({workload!r})
print(json.dumps({{"forbidden": loaded_forbidden(), "correct": out["result"]["correct"],
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_run_loads_no_jax(workload):
    env_probe = PROBE.format(root=str(registry.ROOT), workload=workload)
    proc = subprocess.run([sys.executable, "-c", env_probe], capture_output=True, text=True,
                          timeout=600, cwd=str(registry.ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert not set(got["modules"]) & set(FORBIDDEN)
    assert "husky_rover_mppi_isaacsim_torch" in got["modules"]
    assert got["correct"] is True


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((registry.BENCH / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("husky_rover_mppi_isaacsim_torch", "rover_bench", *FORBIDDEN), \
                (path.name, name)


def test_no_benchmark_file_imports_jax():
    for path in sorted(registry.BENCH.rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
