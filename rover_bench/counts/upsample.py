"""The block upsample kernel (``csrc/upsample_taps.cu``): a streamed
block's kept base, both 4-tap bicubic passes in one launch. Frozen from
PERF.md's bound of the kernel (commit c6c4900, the ``upsample_taps``
phase of ``chip_smoke.py``): the kept crop written once, the LR patch and
the crop's table rows (four weights and four indices a row) read once; 4
FMAs an output and a row-pass value."""

from rover_bench.counts import peaks

SYMBOLS = ("upsample_block_kernel",)


def bound_s(lr_rows: int, lr_cols: int, out_rows: int, out_cols: int) -> tuple[float, str]:
    moved = 4 * out_rows * out_cols + 4 * lr_rows * lr_cols + 32 * (out_rows + out_cols)
    fmas = 4 * out_rows * out_cols + 4 * out_rows * lr_cols
    return peaks.bound_s(moved, fmas, peaks.PEAK_FP32_INSTR_S)
