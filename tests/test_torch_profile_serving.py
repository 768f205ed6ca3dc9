"""The serving profiler's bookkeeping (segmentation_tpu_torch/
profile_serving.py), on CPU: which group a device activity's name falls
in, and the union of overlapping activity intervals."""

import pytest

from segmentation_tpu_torch import profile_serving as ps


@pytest.mark.parametrize("name,group", [
    ("void entry_chain_kernel(Strided4x4Loader<bf16, false>, ...)",
     "H5 entry_chain"),
    ("void packed_conv2x2_dual_s8_kernel(DualLoader<s8>, ...)",
     "H2 packed_conv2x2_dual"),
    ("void packed_conv2x2_s8_kernel<true>(Conv2x2Loader<s8>, ...)",
     "H1 packed_conv2x2"),
    ("void segk::packed_conv2x2_dual_fwd_kernel<256, 1, 0>("
     "segk::FwdTiles<256, 1, 0>)", "H2 packed_conv2x2_dual"),
    ("void segk::packed_conv2x2_fwd_kernel<128, 0, 1>("
     "segk::FwdTiles<128, 0, 1>)", "H1 packed_conv2x2"),
    ("void segk::packed_conv2x2_dual_fwd_kernel<256, true, 28, true>("
     "segk::FwdTiles<256, true, 28, true>)", "H2 packed_conv2x2_dual"),
    ("void segk::packed_conv2x2_fwd_kernel<128, false, 12, false>("
     "segk::FwdTiles<128, false, 12, false>)", "H1 packed_conv2x2"),
    ("void segk::packed_conv2x2_dgrad_kernel<128, true>("
     "segk::DgradTiles<128, true>)", "H6 packed_conv2x2_dgrad"),
    ("void strided_conv4x4s2_kernel<true>(...)", "H3 strided_conv4x4s2"),
    ("void segk::strided_conv4x4s2_fwd_kernel<128, false>("
     "segk::StridedTiles<128, false>)", "H3 strided_conv4x4s2"),
    ("void segk::rows_matmul_fwd_kernel<256, true>("
     "segk::RowsTiles<256, true>)", "H4 rows_matmul"),
    ("void rows_matmul_s8_kernel(RowsLoader<s8>, ...)", "H4 rows_matmul"),
    ("void segk::rows_matmul_s8_kernel<128, 1>(segk::RowsS8Tiles<128, 1>)",
     "H4 rows_matmul"),
    ("void segk::std_conv3x3_s8_kernel<128, false, false, true>("
     "segk::StdTiles<128, false, false, true>)", "H8 std_conv3x3_s8"),
    ("void segk::std_conv3x3_dual_s8_kernel<256, true, false, false>("
     "segk::StdTiles<256, true, false, false>)", "H8 std_conv3x3_s8"),
    ("void segk::std_conv3x3_bf16_kernel<256, false>("
     "segk::StdBf16Tiles<256, false>)", "H8 std_conv3x3 bf16"),
    ("void segk::std_conv3x3_dual_bf16_kernel<128, true>("
     "segk::StdBf16Tiles<128, true>)", "H8 std_conv3x3 bf16"),
    ("void segk::(anonymous namespace)::crop_normalize_kernel<"
     "__nv_bfloat16>(unsigned char const*, ...)", "H7 crop_normalize"),
    ("cutlass_80_wmma_tensorop_i161616gemm_s8_32x32_128x1_tn_align16",
     "library GEMM"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
     "library conv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "library GEMM"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>(...)",
     "library conv"),
    ("nvjet_tst_128x128_64x6_2x1_v_bz_splitK_NTT", "library GEMM"),
    ("void segk::(anonymous namespace)::relu_bias_grad_kernel<true, true>("
     "uint4 const*, ...)", "glue relu_bias_grad"),
    ("void segk::(anonymous namespace)::bias_reduce_kernel(float const*, "
     "float*, int, int)", "glue relu_bias_grad"),
    ("void segk::(anonymous namespace)::crop_margin_zero_kernel(uint4*, "
     "int, int, int, int, int, int, int)", "glue crop_margin_zero"),
    ("Memcpy DtoD (Device -> Device)", "copies"),
    ("void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>",
     "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::clamp_scalar_kernel_impl>",
     "other (elementwise, pools, reductions)"),
])
def test_group_of(name, group):
    assert ps.group_of(name) == group


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),            # disjoint
    ([(0.0, 4.0), (1.0, 2.0)], 4.0),            # nested
    ([(3.0, 6.0), (0.0, 4.0), (6.0, 7.0)], 7.0),  # overlapping, touching
])
def test_union_us(spans, want):
    assert ps.union_us(spans) == want
