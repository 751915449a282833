"""``jax_normal``'s share of its roofline: the least time of the slice's
draws (``counts/jax_normal.py``: the busiest pipe at the card's highest SM
clock as nvidia-smi reads it, or the bytes, whichever is larger; each draw
a step of the cell's sizes, the value shares of the checked step's draw)
over the time the kernel took in the trace."""


def read(run):
    t, r = run.trace, run.record
    clock = run.card.get("max_sm_hz")
    if not t or not t.counters.get("steps") or not clock or "jax_normal_shares" not in r:
        return None
    jn = run.count("jax_normal")
    spent = t.kernel_s(jn.SYMBOLS)
    if spent <= 0:
        return None
    per_step = sum(jn.bound_s(n, r["jax_normal_shares"], clock)[0] for n in r["draws_per_step"])
    return 100.0 * per_step * t.counters["steps"] / spent
