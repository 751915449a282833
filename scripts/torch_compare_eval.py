"""Collided counts of two thesis-protocol tables side by side, with Fisher's
exact test per K and arm.

    python scripts/torch_compare_eval.py [PORT_TABLE] [JAX_TABLE] ...

Defaults: ``EVAL_torch_r05.json`` (the port's run on the card) against
``EVAL_r05.json`` (the JAX package's); a calibration sweep (``calib``) is
compared per terrain z_scale, the episode experiment (``EVAL_torch.json``
against ``EVAL.json``) per K on its runs that reached the goal (its
collision counts, summed points, beside them). For each K and arm it prints one
JSON line: both tables' collided, completed and failed counts and the
two-sided p of Fisher's exact test on the 2 x 2 table (collided, not
collided) x (table), over every run of the arm. More tables after the
second are compared with the first the same way.
"""

import argparse
import json
import sys
from math import comb
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fisher_exact_p(a: int, b: int, c: int, d: int) -> float:
    """Two-sided p of Fisher's exact test on [[a, b], [c, d]]: the sum of
    the hypergeometric probabilities of every table with the same margins
    that is no more likely than the observed one."""
    row1, col1, n = a + b, a + c, a + b + c + d

    def prob(x: int) -> float:
        return comb(col1, x) * comb(n - col1, row1 - x) / comb(n, row1)

    observed = prob(a)
    lo, hi = max(0, row1 + col1 - n), min(row1, col1)
    return min(1.0, sum(p for p in map(prob, range(lo, hi + 1))
                        if p <= observed * (1 + 1e-9)))


def _arm_rows(table: dict) -> dict:
    """``{(key, arm): counts}``: per K of a protocol table, per terrain
    z_scale of a calibration sweep (``run_eval_r05.py calib``), or per K of
    the episode experiment (``EVAL.json``: its collision points summed over
    the runs, and the runs that reached the goal, of ``runs_per_arm``).
    Each ``counts`` has ``runs``; a protocol table's ``collided``,
    ``completed`` and ``failed`` runs, an episode table's ``collisions``
    and ``reached``."""
    if "sweep" in table:
        rows = {(f"z{e['z_scale']}", arm): dict(counts) for e in table["sweep"]
                for arm, counts in e["arms"].items()}
    elif all("arms" in row for row in table["per_k"].values()):
        rows = {(int(k), arm): dict(counts) for k, row in table["per_k"].items()
                for arm, counts in row["arms"].items()}
    else:
        runs = table["config"]["runs_per_arm"]
        return {(int(k), arm): {"collisions": row["collisions"][arm],
                                "reached": row["reached"][arm], "runs": runs}
                for k, row in table["per_k"].items() for arm in row["collisions"]}
    for counts in rows.values():
        counts["runs"] = counts["completed"] + counts["collided"] + counts["failed"]
    return rows


def compare(port: dict, ref: dict) -> list[dict]:
    """One row per K (or z_scale) and arm of ``port``: both tables' counts
    and Fisher's p over every run of the arm: of the collided runs of a
    protocol table, of the runs that reached the goal for the episode
    experiment (its collisions are point counts, reported beside)."""
    rows = []
    want_rows = _arm_rows(ref)
    for (key, arm), got in _arm_rows(port).items():
        want = want_rows[key, arm]
        row = {"K": key, "arm": arm}
        for name in ("collided", "completed", "failed", "collisions", "reached"):
            if name in got:
                row[name] = [got[name], want[name]]
        row["runs"] = [got["runs"], want["runs"]]
        name = "collided" if "collided" in got else "reached"
        row["fisher_p" if name == "collided" else "fisher_p_reached"] = fisher_exact_p(
            got[name], got["runs"] - got[name], want[name], want["runs"] - want[name])
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tables", nargs="*", default=["EVAL_torch_r05.json", "EVAL_r05.json"])
    args = ap.parse_args(argv)
    paths = [Path(p) if Path(p).is_absolute() else ROOT / p for p in args.tables]
    if len(paths) < 2:
        ap.error("give at least two tables")
    tables = [json.loads(p.read_text()) for p in paths]
    ref = tables[1]
    for path, table in [(paths[0], tables[0])] + list(zip(paths[2:], tables[2:])):
        for row in compare(table, ref):
            print(json.dumps({"table": path.name, "against": paths[1].name, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
