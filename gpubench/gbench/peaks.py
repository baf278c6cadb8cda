"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data sheet, at
the full 700 W power limit.

The data sheet gives no INT32 rate.  The decoder's arithmetic is integer;
OPS_PER_S is the data sheet's FP32 rate outside the tensor cores (67
TFLOP/s), an upper bound on the integer rate (Hopper issues half as many
INT32 as FP32 operations a clock), so a least time taken from it is a
lower bound and a roofline share taken from it never reads too high.
"""
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the memory bandwidth and the operations over the operation rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)
