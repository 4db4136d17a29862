"""senas_torch: the SENAS framework in PyTorch for one NVIDIA H100.

A port of `senas_tpu` (JAX/Flax/Pallas), which stays in the repository as
the reference the port is held against. The port imports nothing of it.
Entry points run on the card (`device=None` means "cuda") unless the
caller asks for the CPU; on the CPU every kernel wrapper takes its plain
PyTorch version, on the card it launches the hand-written CUDA kernel.
"""

__version__ = "0.1.0"

from senas_torch._exports import lazy_exports  # noqa: E402

# the JAX package's root exports, imported at first use
_EXPORTS = {name: "senas_torch.core.genotype"
            for name in ("Genotype", "GenoParser", "parse_genotype")}
__getattr__ = lazy_exports(__name__, _EXPORTS)
