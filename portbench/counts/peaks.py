"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity), at its full power limit of 700 W."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12
