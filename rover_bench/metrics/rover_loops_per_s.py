"""MPPI control loops completed by every rover over the window's host
seconds (a fleet step is one loop of each rover)."""


def read(run):
    r = run.record
    return r["loops"] / r["window_s"] if r.get("window_s") else None
