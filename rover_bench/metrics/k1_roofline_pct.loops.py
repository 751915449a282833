"""K1's share of its roofline: the least time of the slice's control steps'
K1 work (``counts/k1.py`` at the cell's rovers, samples and horizon, with
the DEM cells the checked step's rollouts read) over the time K1's kernels
took in the trace."""


def read(run):
    t, r = run.trace, run.record
    if not t or not t.counters.get("steps") or "dem_cells" not in r:
        return None
    k1 = run.count("k1")
    spent = t.kernel_s(k1.SYMBOLS)
    if spent <= 0:
        return None
    m = run.cell.config["mppi"]
    per_step = k1.step_bound_s(r["rovers"], m["num_samples"], m["horizon"], r["dem_cells"])
    return 100.0 * per_step * t.counters["steps"] / spent
