"""The FLOP and byte counts each configuration's file stores, counted
again on the plain reference, and the K1 launches a search step makes."""

import pytest

from perfbench.lib import cells, counts
from perfbench.lib.profiling import kernel_class

BENCH = cells.load_benchmark()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_stored_counts_recounted(name):
    cfg = cells.load_config(BENCH, name)
    assert counts.counts(cells.load_reference(name), cfg) == cfg["counts"]


def test_k1_bytes_and_launches_of_a_search_step():
    """30 groups a pass; a do_arch step runs each of K1a-K1d twice a group,
    and its bytes are those of the groups' shapes at the batch."""
    name = "senas-search-promise12"
    cfg = cells.load_config(BENCH, name)
    groups = counts.group_shapes(cells.load_reference(name), cfg)
    assert len(groups) == 30 and all(1 <= n <= 6 for n, _ in groups)
    launches = counts.per_step(counts.expected_launches(groups), True)
    assert launches == {"branch_stats": 60, "apply_mix": 60, "bwd_reduce": 60, "bwd_dx": 60}
    n, shape = groups[0]
    one = counts.k1_bytes(n, shape, 1)
    assert counts.k1_bytes(n, shape, 4) == {k: 4 * v for k, v in one.items()}
    t = shape[1] * shape[2] * shape[3] * 4
    assert one["bwd_dx"] == (2 * n + 1) * t + 3 * n * shape[1] * 4


@pytest.mark.parametrize("kernel,cls", [
    ("void branch_stats_cta_kernel<float, true>(Branches<float>, long long, int, float*)",
     "branch_stats (K1a)"),
    ("void branch_stats_warp_kernel<float, false>(Branches<float>, long long, int, float*)",
     "branch_stats (K1a)"),
    ("void apply_mix_kernel<float>(Branches<float>, float const*)", "apply_mix (K1b)"),
    ("void bwd_reduce_finish_kernel(float const*, int, int)", "bwd_reduce (K1c)"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc", "convolution"),
    ("void at::native::batch_norm_backward_kernel<float>", "batch norm"),
    # names from an H100's trace of the search, train and serve cells, each
    # class as the aten operator that launched the kernel says
    ("void cudnn::bn_bw_1C11_kernel_new<float, float, float2, 512, true, 1>(float, float)",
     "batch norm"),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, false, false, true>"
     "(int, int, int, float const*)", "convolution"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize64x32x8_stage3"
     "_warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_kernel__5x_cudnn", "convolution"),
    ("void cudnn::engines_precompiled::genericTranspose_kernel<float, float, float, true, "
     "(cudnnKernelDataType_t)0>(float)", "convolution"),
    ("void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>(int, int)", "convolution"),
    ("void fft2d_c2r_32x32<float, false, false, 0u, false, false>(float*)", "convolution"),
    ("void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>(float2*)",
     "convolution"),
    ("void internal::region_transform_ABC_val<int, 32, 32, false, internal::Transform"
     "ParamsABC<float2>>", "convolution"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x32x8_stage3_warpsize2x2x1_ffma"
     "_aligna8_alignc8_execute_kernel__5x_cublas", "convolution"),
    ("void at::native::(anonymous namespace)::conv_depthwise2d_grad_weight_kernel<float, "
     "unsigned int>()", "convolution"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma"
     "_aligna4_alignc4_execute_kernel__5x_cublas", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1>(cutlass_80_simt_sgemm"
     "_64x64_8x5_nn_align1::Params)", "matmul"),
    ("void gemvNSP_kernel<float, float, float, float, 1, 32, 4, 1024, false, cublasGemvParamsEx"
     "<int>>", "matmul"),
])
def test_kernel_classes(kernel, cls):
    assert kernel_class(kernel) == cls
