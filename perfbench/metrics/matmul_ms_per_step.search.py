"""Device ms a profiled step in cuBLAS's matmul kernels: the pointwise
einsum of the fused cells (senas_torch/search/fused_cell.py), forward and
both gradients, and the few real f32 GEMMs cuDNN has cuBLAS run for a
convolution's gradient (1.2 of 642 ms a step on an H100)."""

from perfbench.lib import readers


def read(run):
    return readers.per_unit_ms(run, ("matmul",))
