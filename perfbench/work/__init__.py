"""Bytes and operations of the kernels' work, one file a kernel, and the
published peaks of the chip they are held against."""

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): the device
# memory rate and the float32 rate outside the tensor cores.  A call's bound
# is the larger of bytes / HBM_RATE and operations / FP32_RATE.
HBM_RATE = 3.35e12
FP32_RATE = 67e12

# Operation-count model (one multiply or add = 1, one multiply-add = 2)
OPS_PHILOX = 60        # 10 rounds x (2 wide multiplies + 4 xor/add)
OPS_TRANSC = 20        # one logf / expf / cosf / sqrtf / division


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the chip could take: seconds."""
    return max(n_bytes / HBM_RATE, n_ops / FP32_RATE)
