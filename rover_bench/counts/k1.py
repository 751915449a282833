"""K1, the 2.5D rollout kernel (``csrc/rollout.cu``): its work at a
launch's shapes. Frozen from ``chip_smoke.py:243-245`` (``K1_FLOPS_PER_STEP``)
and ``:680-683`` (``k1_bound``), commit c6c4900: the velocities in, the
trajectory, headings and (with wheel tracks) both tracks out, four bytes
a DEM cell the rollouts read, five floats of start state a rover; 150
float32 operations a sample-step."""

from rover_bench.counts import peaks

SYMBOLS = ("rollout25d_kernel",)
FLOPS_PER_STEP = 150


def bytes_moved(n: int, k: int, h: int, wheels: bool, dem_cells: int) -> int:
    channels = 12 if wheels else 6
    return (2 + channels) * n * k * h * 4 + 4 * dem_cells + 4 * n * 5


def bound_s(n: int, k: int, h: int, wheels: bool, dem_cells: int) -> tuple[float, str]:
    """The least seconds of one launch (``n`` rovers of ``k`` samples over
    ``h`` steps) and what sets it."""
    return peaks.bound_s(bytes_moved(n, k, h, wheels, dem_cells), FLOPS_PER_STEP * n * k * h,
                         peaks.PEAK_FP32_S)


def step_bound_s(n: int, k: int, h: int, dem_cells: int) -> float:
    """A control step's two launches: the samples with wheel tracks, the
    optimal rollout (one sample a rover, no tracks; its few cells not
    counted)."""
    return bound_s(n, k, h, True, dem_cells)[0] + bound_s(n, 1, h, False, 0)[0]
