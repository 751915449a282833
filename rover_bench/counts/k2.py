"""K2, the exact EDT's column envelope (``csrc/edt_minplus.cu``):
``D2[y, x] = min_y' (y - y')^2 + g2[y', x]`` over an ``(R, C)`` grid. Frozen
from ``chip_smoke.py:685-688`` (``k2_bound``), commit c6c4900: the grid
read and written once; each candidate one float32 add, and one three-way
min settles two candidates, so 1.5 instructions a candidate."""

from rover_bench.counts import peaks

SYMBOLS = ("minplus_kernel",)


def bound_s(rows: int, cols: int) -> tuple[float, str]:
    return peaks.bound_s(2 * rows * cols * 4, 1.5 * rows * rows * cols,
                         peaks.PEAK_FP32_INSTR_S)
