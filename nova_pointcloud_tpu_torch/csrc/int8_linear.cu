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
// What bounds it on this card: at the t2i serving shapes (M from 2304 to
// 10240, K = 1024, N = 3072 for qkv and 1024 for the out-projection) the int8
// product, 2*M*K*N operations (0.033 ms at 10240 x 1024 -> 3072 against the
// 1979 TOP/s int8 peak); its bytes (f32 or bf16 x in, bf16 y out, the weight)
// take about half that. Design: two launches. (1) The row pass without
// LayerNorm (quant.cuh, one warp a row, 16-byte loads and stores) writes the
// int8 rows and their scales; (2) the product on the wgmma + TMA GEMM
// (int8_wgmma.cuh) with the cast-then-bias epilogue (EPI_CAST_BIAS of
// int8_epilogue.cuh, the mma.sync GEMM's values, so the outputs are the
// first design's bit for bit); a bf16 output goes out through shared memory
// by TMA while the next tile's products run. grid, block_n (the tile width,
// 256 or 128) and smem_bytes are the caller's launch plan (ops/kernels/
// fused_block.store_plan), checked against the GEMM's own before anything
// launches.

#include "int8_wgmma.cuh"

extern "C" int nova_int8_linear(
    const void* x, int x_bf16, int M, int K, int N,
    const void* bias, int bias_bf16, const int8_t* wt, const float* w_scale,
    int8_t* q, float* sx, void* y, int y_bf16, int grid, int block_n, int smem_bytes,
    void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!wg8::plan_store(block_n, y_bf16, M, N, K, grid, smem_bytes))
    return cudaErrorInvalidConfiguration;
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
  return wg8::launch_store<EPI_CAST_BIAS>(block_n, y_bf16, q, wt, M, N, K, e, grid, smem_bytes,
                                          stream);
}
