"""How often a ``torch.profiler`` session drops device records, on the card.

``ops/measure.device_kernels`` counts the kernels of a call from the
profiler's device events. This script runs many one-call sessions of a K1
call (one kernel) and of a chain of eager operators (two kernels each), and
prints the histogram of the counts a single session reads, then the counts
``device_kernels`` returns for the same calls (it reads sessions until the
largest count has been read twice, or returns the largest of its
sessions). Needs one CUDA card and builds K1:

    python3 scripts/torch_profiler_drops.py [--sessions 60]

One JSON line per case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from husky_rover_mppi_isaacsim_torch.core import HeightField  # noqa: E402
from husky_rover_mppi_isaacsim_torch.ops import measure  # noqa: E402
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda  # noqa: E402


def one_session(fn) -> int:
    """The kernels one profiler session reads for one call of ``fn``."""
    events, _ = measure._profiled_events(fn)
    return sum(1 for e in events if not e.name.startswith(("Memcpy", "Memset")))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sessions", type=int, default=60)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(0)
    hf = HeightField.create(torch.rand((1500, 1500), generator=gen, device=cuda), 75.0)
    lin = torch.rand((1000, 100), generator=gen, device=cuda)
    pos, heading = torch.zeros(2, device=cuda), torch.tensor([1.0, 0.0, 0.0], device=cuda)

    def k1_call():
        rollout_25d_cuda(hf, pos, heading, lin, lin, 0.045)

    def eager_chain():  # 100 x (mul, add) = 200 kernels
        x = lin
        for _ in range(100):
            x = x * 1.0001 + 0.1

    for name, fn, true_count in (("k1_call", k1_call, 1), ("eager_chain", eager_chain, 200),
                                 ("k1_call_again", k1_call, 1)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = collections.Counter(one_session(fn) for _ in range(args.sessions))
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        settled = collections.Counter(measure.device_kernels(fn) for _ in range(args.sessions))
        print(json.dumps({
            "case": name, "kernels_per_call": true_count, "sessions": args.sessions,
            "one_session_counts": {str(k): v for k, v in sorted(single.items())},
            "one_session_short": sum(v for k, v in single.items() if k != true_count),
            "device_kernels_counts": {str(k): v for k, v in sorted(settled.items())},
            "device_kernels_wrong": sum(v for k, v in settled.items() if k != true_count),
            "one_session_s": single_s / args.sessions,
            "device_kernels_s": (time.perf_counter() - t0) / args.sessions}), flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
