"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at its 700 W limit)."""

F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
