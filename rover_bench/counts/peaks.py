"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; 700 W):
HBM bytes per second and float32 rates outside the tensor cores (67
TFLOP/s counts an FMA as two operations), and the H100's lanes per SM and
clock by pipe. Frozen from ``chip_smoke.py:238-240, 306-307`` (commit
c6c4900)."""

PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_FP32_INSTR_S = PEAK_FP32_S / 2
SM_LANES = {"alu": 64, "fma": 128, "xu": 16, "issue": 128}
H100_SMS = 132


def bound_s(bytes_moved: float, ops: float, op_rate: float) -> tuple[float, str]:
    """The least seconds for ``bytes_moved`` bytes and ``ops`` operations at
    ``op_rate`` per second, and which of the two sets it
    (``chip_smoke.py:309-313``)."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, ops / op_rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
