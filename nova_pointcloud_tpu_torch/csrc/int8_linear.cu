// Int8 linear projection of the NOVA ViT attention, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX model runs these projections as plain XLA
// (nova_pointcloud_tpu/models/vit.py, Attention._int8_proj, through
// ops/quantization.int8_matmul):
//
//   y = cast(q8_rows(x) @ W * sx * s) + cast(b)      in the output dtype
//
// per-row activation quant (divide by max(amax_row / 127, 1e-8)), the product
// cast to the output dtype BEFORE the bias is added, and the bias added in that
// dtype, as the JAX model rounds. The weight comes K-major: wt (N, K).
//
// What bounds it on this card: at the t2i serving shapes (M up to 10240, K =
// 1024, N = 3072 for qkv) the int8 product, 2*M*K*N operations. Design: two
// launches, the port's row pass (no LayerNorm) and its int8 GEMM
// (int8_gemm.cuh) with the cast-then-bias epilogue.

#include "int8_gemm.cuh"

extern "C" int nova_int8_linear(
    const void* x, int x_bf16, int M, int K, int N,
    const void* bias, int bias_bf16, const int8_t* wt, const float* w_scale,
    int8_t* q, float* sx, void* y, int y_bf16, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = launch_row_quant(x, x_bf16, M, K, nullptr, nullptr, 0, nullptr, q, sx,
                                     stream);
  if (err != cudaSuccess) return err;
  EpiParams e = {};
  e.sx_rows = sx;
  e.w_scale = w_scale;
  e.bias = bias;
  e.bias_bf16 = bias_bf16;
  e.out = y;
  e.out_bf16 = y_bf16;
  return launch_gemm_s8<EPI_CAST_BIAS>(q, wt, M, N, K, e, stream);
}
