"""Collided counts of two thesis-protocol tables side by side, with Fisher's
exact test per K and arm.

    python scripts/torch_compare_eval.py [PORT_TABLE] [JAX_TABLE] ...

Defaults: ``EVAL_torch_r05.json`` (the port's run on the card) against
``EVAL_r05.json`` (the JAX package's); a calibration sweep (``calib``) is
compared per terrain z_scale. For each K and arm it prints one
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
    """``{(key, arm): counts}``: per K of a protocol table, or per terrain
    z_scale of a calibration sweep (``run_eval_r05.py calib``)."""
    if "sweep" in table:
        return {(f"z{e['z_scale']}", arm): counts for e in table["sweep"]
                for arm, counts in e["arms"].items()}
    return {(int(k), arm): counts for k, row in table["per_k"].items()
            for arm, counts in row["arms"].items()}


def compare(port: dict, ref: dict) -> list[dict]:
    """One row per K (or z_scale) and arm of ``port``: both tables' counts
    and Fisher's p of the collided counts over every run of the arm."""
    rows = []
    want_rows = _arm_rows(ref)
    for (key, arm), got in _arm_rows(port).items():
        want = want_rows[key, arm]
        n_got = got["completed"] + got["collided"] + got["failed"]
        n_want = want["completed"] + want["collided"] + want["failed"]
        rows.append({
            "K": key, "arm": arm,
            "collided": [got["collided"], want["collided"]],
            "completed": [got["completed"], want["completed"]],
            "failed": [got["failed"], want["failed"]],
            "runs": [n_got, n_want],
            "fisher_p": fisher_exact_p(got["collided"], n_got - got["collided"],
                                       want["collided"], n_want - want["collided"]),
        })
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
