"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at a
700 W limit), copied from chip_smoke.py `PEAK_*`, with bf16 added."""

PEAK_BYTES_PER_S = 3.35e12     # HBM3
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12       # bf16 on the tensor cores
