"""The thesis's 2D-vs-3D statistics experiment under the thesis's own
protocol, with the K=500 wheel-critic ablation, on the PyTorch port. The
port's counterpart of scripts/run_thesis_eval.py (see its docstring for the
protocol), through husky_rover_mppi_isaacsim_torch/mppi/thesis_runs.py.

Usage:
  python scripts/torch_run_thesis_eval.py [runs_per_arm]    # -> EVAL_torch_r04.json

Options: ``--out PATH`` writes elsewhere (never to a JAX artifact's name);
``--device cpu`` runs on the CPU. By default it runs on the CUDA card and
fails without one.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from husky_rover_mppi_isaacsim_torch.mppi import thesis_runs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs_per_arm", nargs="?", type=int, default=64)
    ap.add_argument("--out")
    ap.add_argument("--device")
    args = ap.parse_args(argv)
    try:
        out = thesis_runs.output_path(args.out, "EVAL_torch_r04.json", ROOT)
    except ValueError as exc:
        ap.error(str(exc))
    table = thesis_runs.thesis_eval(args.runs_per_arm, device=args.device)
    out.write_text(json.dumps(table, indent=1))
    print(json.dumps({k: v["arms"] for k, v in table["per_k"].items()}, default=str))
    print(json.dumps({"done": True, "wall_s": table["config"]["wall_s"], "out": str(out)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
