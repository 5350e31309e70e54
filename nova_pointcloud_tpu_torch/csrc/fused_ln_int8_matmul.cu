// LayerNorm -> per-row int8 quant -> one int8 product, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_ln_int8_matmul
// (nova_pointcloud_tpu/ops/pallas/fused_block.py, _ln_matmul_kernel):
//
//   y = (q8_rows(LN(x)) @ W) * sx * s + b        in x's dtype
//
// the QKV projection of the split int8 serving path (token counts too long
// for the one-kernel attention sub-block). LN eps is 1e-6; the quant is per
// row only (divide by max(amax_row / 127, 1e-8), round half to even): the
// function takes no calibrated scale. The weight comes K-major: wt (N, K)
// row-major.
//
// What bounds it on this card: the int8 product, 2*M*K*N operations (0.059 ms
// at M=32768, K=768, N=2304 against the 1979 TOP/s int8 peak); its bytes (x in,
// y out in bf16, 1.8 MB of weights) take 0.060 ms at 3.35 TB/s, so at these
// shapes the two bounds meet. Design: two launches. (1) one block per row
// holds the row in registers, does LN and the quant, and writes int8 codes and
// the row scale (the LN pass rows 1 and 2 share, whose sum order fixes their
// outputs); (2) the product on the wgmma + TMA GEMM (int8_wgmma.cuh), whose
// store epilogue (EPI_STORE of int8_epilogue.cuh, the mma.sync GEMM's
// values, so the outputs are the first design's bit for bit) applies acc *
// sx * s + b, a bf16 output going out through shared memory by TMA while
// the next tile's products run. The int8 row (M x K bytes) is the one
// intermediate that goes through device memory. grid, block_n (the tile
// width) and smem_bytes are the caller's launch plan (ops/kernels/
// fused_block.store_plan), checked against the GEMM's own before anything
// launches.

#include "int8_wgmma.cuh"

extern "C" int nova_fused_ln_int8_matmul(
    const void* x, int x_bf16, int M, int K, int N,
    const void* ln_w, const void* ln_b, const void* bias, int vec_bf16,
    const int8_t* wt, const float* w_scale,
    int8_t* q, float* sx, void* y, int grid, int block_n, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (ln_w == nullptr || ln_b == nullptr) return cudaErrorInvalidValue;
  if (!wg8::plan_store(block_n, x_bf16, M, N, K, grid, smem_bytes))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_row_quant(x, x_bf16, M, K, ln_w, ln_b, vec_bf16, nullptr, q, sx,
                                     stream);
  if (err != cudaSuccess) return err;
  EpiParams e = {};
  e.sx_rows = sx;
  e.w_scale = w_scale;
  e.bias = bias;
  e.bias_bf16 = vec_bf16;
  e.out = y;
  e.out_bf16 = x_bf16;
  return wg8::launch_store<EPI_STORE>(block_n, x_bf16, q, wt, M, N, K, e, grid, smem_bytes,
                                      stream);
}
