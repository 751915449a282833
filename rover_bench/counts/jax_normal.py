"""The ``jax_normal`` kernel (``csrc/jax_normal.cu``): the operations of one
value of JAX's float32 ``jax.random.normal`` by the pipe each issues on,
each data-dependent side weighed by the share of the draw's values that
take it, and the bytes. Frozen from ``chip_smoke.py:276-305``
(``JAX_NORMAL_OPS``) and ``:620-636`` (the bound), commit c6c4900; the
derivation of every count is in that comment."""

from rover_bench.counts import peaks

SYMBOLS = ("jax_normal_kernel",)
OPS = {"common": {"alu": 79, "fma": 13},
       "rational": {"fma": 20, "xu": 1}, "log": {"alu": 9, "fma": 20, "xu": 1},
       "w_lt5": {"fma": 1}, "w_ge5": {"fma": 1, "xu": 1}}


def per_value(shares: dict) -> dict:
    """Operations a value by pipe, and all of them against the issue rate."""
    out = {p: sum(shares[side] * ops.get(p, 0) for side, ops in OPS.items())
           for p in ("alu", "fma", "xu")}
    out["issue"] = sum(out.values())
    return out


def bound_s(n: int, shares: dict, max_sm_hz: float) -> tuple[float, str]:
    """The least seconds of one draw of ``n`` values at the card's highest
    SM clock: the larger of the busiest pipe's and the bytes' (``4n + 16``:
    the values written, the key read and written)."""
    pipes = {p: n * c / (peaks.SM_LANES[p] * peaks.H100_SMS * max_sm_hz)
             for p, c in per_value(shares).items()}
    bytes_s = (4 * n + 16) / peaks.PEAK_BYTES_S
    busiest = max(pipes, key=pipes.get)
    return (bytes_s, "bytes") if bytes_s >= pipes[busiest] else (pipes[busiest], busiest)
