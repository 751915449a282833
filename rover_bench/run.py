"""The benchmark of ``husky_rover_mppi_isaacsim_torch`` on NVIDIA GPUs.

    python3 rover_bench/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it builds the cell's world on the card from the
seed, warms up the cell's graphs (set-up, ``setup_s``), drives the port's
entry for ``--seconds`` seconds of the cell's traffic, checks what the
window produced against the plain reference in ``rover_bench/reference``,
and prints one JSON line last on standard output (the numbers it compared
are the last lines on standard error). With ``--trace 1`` a slice of the
window runs under ``torch.profiler`` and the line holds the per-layer
metrics instead of the end-to-end ones. Everything that belongs to one
configuration, traffic mix, metric or kernel count is a file of its own
under ``configs/``, ``traffic/``, ``metrics/`` and ``counts/``, found by the
name ``BENCHMARK.json`` gives it; a mix names its driver in ``drivers/``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from rover_bench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
