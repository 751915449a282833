"""The control on the card: the reference at the next lower precision
(float32 with TF32 on, where the configuration states float32 with TF32
off) in the program's place, at each cell's own size, on three seeds, has
to come out not correct. The benchmark's own runs never run it."""

import json
import subprocess
import sys

import pytest

from rover_bench.harness import registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(card, workload, seed):
    proc = subprocess.run(
        [sys.executable, str(registry.BENCH / "run.py"), "--workload", workload, "--seed",
         str(seed), "--seconds", "3", "--trace", "0", "--control", "1"],
        capture_output=True, text=True, timeout=600, cwd=str(registry.ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(workload, seed, json.dumps(result["checked"]))
    assert result["correct"] is False, result["checked"]
