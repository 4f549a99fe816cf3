"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): FLOP/s by compute type and
HBM bandwidth. TF32 is not listed: the program switches it off, so float32
computes at the float32 rate."""

FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
BYTES_PER_S = 3.35e12
