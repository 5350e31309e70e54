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
// int8 operations (0.020 ms at 1979 TOP/s). Design: two launches. (1) one
// block per row quantizes it from registers; (2) the shared int8 GEMM
// (int8_gemm.cuh) whose epilogue adds the bias and the residual. The int8 row
// goes through device memory, which adds M*K bytes written and read to the
// traffic the bound counts.

#include "int8_gemm.cuh"

extern "C" int nova_int8_matmul_residual(
    const void* x, int x_bf16, int M, int K, int N,
    const void* res, int res_bf16, const void* bias, int bias_bf16,
    const int8_t* wt, const float* w_scale,
    int8_t* q, float* sx, void* y, void* stream_ptr) {
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
  e.resid = res;
  e.resid_bf16 = res_bf16;
  e.out = y;
  e.out_bf16 = res_bf16;
  return launch_gemm_s8<EPI_RESIDUAL>(q, wt, M, N, K, e, stream);
}
