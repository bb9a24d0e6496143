"""NVIDIA H100 SXM published peaks (data sheet, dense, at the 700 W limit):
HBM3 bytes per second and fp32 operations per second outside the tensor
cores. The port's step is fp32 outside the tensor cores. Copied from
chip_smoke.py:PEAK_BYTES_S / PEAK_F32_S at commit 95f6082."""

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card needs: bytes over bandwidth against
    operations over the fp32 peak, whichever is larger."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)
