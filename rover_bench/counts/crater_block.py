"""The crater block kernel (``csrc/crater_block.cu``): one tier of craters
rendered and added into a block raster. Frozen from ``chip_smoke.py:274``
(``CRATER_OPS_PER_PAIR``, whose comment counts them) and ``:748-768``
(``crater_work``), commit c6c4900: 71 operations a (slot, pixel) pair
inside a crater's square; a read and a write of each covered pixel, nine
columns of each live slot and each profile-table row a live slot uses."""

from rover_bench.counts import peaks

SYMBOLS = ("crater_block_kernel",)
OPS_PER_PAIR = 71


def bytes_moved(covered_px: int, live_slots: int, table_rows: int, table_width: int) -> int:
    return 8 * covered_px + 36 * live_slots + table_rows * table_width * 4


def bound_s(pairs: int, covered_px: int, live_slots: int, table_rows: int,
            table_width: int) -> tuple[float, str]:
    return peaks.bound_s(bytes_moved(covered_px, live_slots, table_rows, table_width),
                         OPS_PER_PAIR * pairs, peaks.PEAK_FP32_INSTR_S)
