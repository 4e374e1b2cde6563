"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet,
dense rates without sparsity, at its 700 W power limit). A card set
below 700 W runs slower under load: every share of a peak is printed
beside the card's power limit (``run.power_limit``)."""

BF16_FLOPS = 989e12  # bf16 and fp16 tensor cores
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12  # outside the tensor cores
FP8_FLOPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
