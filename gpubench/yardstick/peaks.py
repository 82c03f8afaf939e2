"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
# Operations per second by the precision a configuration states.
OPS_PER_S = {
    "float32": 67e12,  # outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
}
