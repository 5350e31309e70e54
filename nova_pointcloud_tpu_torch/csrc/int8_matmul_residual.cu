// Per-row int8 quant -> one int8 product -> bias and residual, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel int8_matmul_residual
// (nova_pointcloud_tpu/ops/pallas/fused_block.py, _matmul_res_kernel):
//
//   y = res + (q8_rows(x) @ W) * sx * s + b      in f32, cast to res's dtype
//
// the attention out-projection of the split int8 serving path. No LayerNorm;
// the per-row amax spans the whole K-wide row (all heads' outputs). x and res
// may differ in dtype. The weight comes K-major: wt (N, K) row-major.
//
// What bounds it on this card: bytes. At M=32768, K=N=768 it reads x and res
// and writes y in bf16 (151 MB, 0.045 ms at 3.35 TB/s) for 2*M*K*N = 3.9e10
// int8 operations (0.020 ms at 1979 TOP/s). Design: two launches. (1) The
// row pass without LayerNorm (quant.cuh, one warp a row, 16-byte loads and
// stores) writes the int8 rows and their scales; (2) the product on the
// wgmma + TMA GEMM (int8_wgmma.cuh) with the residual epilogue (EPI_RESIDUAL
// of int8_epilogue.cuh, whose values are the first design's mma.sync
// GEMM's, so the outputs are bit for bit the same). A bf16 residual (and
// so output) is loaded by TMA into shared memory while a tile's products
// run, the product added there and the sum stored by TMA (TMA_OUT); an f32
// one takes the path rows 1 and 2 run (the residual rows prefetched into
// L2 while the products run, loaded and y stored by the threads). The int8
// row goes through device memory, which adds M*K bytes written and read to
// the traffic the bound counts. grid, block_n (the tile width, 256 or 128)
// and smem_bytes are the caller's launch plan (ops/kernels/fused_block.
// store_plan, with a TMA-store layout for a bf16 residual), checked against
// the GEMM's own before anything launches.

#include "int8_wgmma.cuh"

extern "C" int nova_int8_matmul_residual(
    const void* x, int x_bf16, int M, int K, int N,
    const void* res, int res_bf16, const void* bias, int bias_bf16,
    const int8_t* wt, const float* w_scale,
    int8_t* q, float* sx, void* y, int grid, int block_n, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (res == nullptr || bias == nullptr) return cudaErrorInvalidValue;
  const int tma_out = res_bf16;  // the residual in and y out through shared memory by TMA
  if (!wg8::plan_store(block_n, tma_out, M, N, K, grid, smem_bytes))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_row_quant(x, x_bf16, M, K, nullptr, nullptr, 0, nullptr, q, sx,
                                     stream);
  if (err != cudaSuccess) return err;
  EpiParams e = {};
  e.sx_rows = sx;
  e.w_scale = w_scale;
  e.bias = bias;
  e.bias_bf16 = bias_bf16;
  e.resid = res;
  e.resid_bf16 = res_bf16;
  e.out = y;
  e.out_bf16 = res_bf16;
  if (block_n == 256)
    return tma_out ? wg8::launch<EPI_RESIDUAL, 256, true>(q, wt, M, N, K, e, grid, smem_bytes,
                                                          stream)
                   : wg8::launch<EPI_RESIDUAL, 256, false>(q, wt, M, N, K, e, grid, smem_bytes,
                                                           stream);
  return tma_out ? wg8::launch<EPI_RESIDUAL, 128, true>(q, wt, M, N, K, e, grid, smem_bytes,
                                                        stream)
                 : wg8::launch<EPI_RESIDUAL, 128, false>(q, wt, M, N, K, e, grid, smem_bytes,
                                                         stream);
}
