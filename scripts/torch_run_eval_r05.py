"""The thesis protocol on the PyTorch port, round-5 form: calibrate the
statistics terrain, then run the whole protocol on the calibrated field.
The port's counterpart of scripts/run_eval_r05.py (see its docstring for
the calibration's anchor), through husky_rover_mppi_isaacsim_torch/mppi/
thesis_runs.py.

Usage:
  python scripts/torch_run_eval_r05.py calib      # -> EVAL_torch_R05_CALIB.json
  python scripts/torch_run_eval_r05.py full Z     # at z_scale Z -> EVAL_torch_r05.json

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
    ap.add_argument("mode", nargs="?", default="calib", choices=["calib", "full"])
    ap.add_argument("z_scale", nargs="?", type=float)
    ap.add_argument("--out")
    ap.add_argument("--device")
    args = ap.parse_args(argv)
    if args.mode == "full" and args.z_scale is None:
        ap.error("full needs the terrain's z_scale: full Z")
    default = "EVAL_torch_R05_CALIB.json" if args.mode == "calib" else "EVAL_torch_r05.json"
    try:
        out = thesis_runs.output_path(args.out, default, ROOT)
    except ValueError as exc:
        ap.error(str(exc))
    if args.mode == "calib":
        table = thesis_runs.eval_r05_calib(device=args.device)
        wall = sum(e["wall_s"] for e in table["sweep"])
    else:
        table = thesis_runs.eval_r05_full(args.z_scale, device=args.device)
        wall = table["wall_s"]
    out.write_text(json.dumps(table, indent=1))
    print(json.dumps({"done": True, "wall_s": wall, "out": str(out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
