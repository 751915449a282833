"""The 95th percentile of every fleet step of the window, from its dispatch
to the rovers' poses on the host, in ms (host clock)."""

import numpy as np


def read(run):
    steps = run.record.get("step_s")
    return 1e3 * float(np.percentile(steps, 95)) if steps else None
