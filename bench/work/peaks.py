"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense
rates without sparsity, at the full power limit of 700 W)."""

HBM_BYTES_PER_S = 3.35e12
# int32 compare issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
INT32_OPS = 132 * 64 * 1.98e9
