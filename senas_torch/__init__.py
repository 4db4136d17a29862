"""senas_torch: the SENAS framework in PyTorch for one NVIDIA H100.

A port of `senas_tpu` (JAX/Flax/Pallas), which stays in the repository as
the reference the port is held against. The port imports nothing of it.
Entry points run on the card (`device=None` means "cuda") unless the
caller asks for the CPU; on the CPU every kernel wrapper takes its plain
PyTorch version, on the card it launches the hand-written CUDA kernel.
"""

__version__ = "0.1.0"
