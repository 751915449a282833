"""Kernel time on the card a control step (a fleet step counts as one),
summed over the traced slice's kernels and divided by the control steps
the slice computed, masked ones included."""


def read(run):
    t = run.trace
    if not t or not t.counters.get("steps"):
        return None
    return 1e3 * sum(op.dur_ns for op in t.kernels()) * 1e-9 / t.counters["steps"]
