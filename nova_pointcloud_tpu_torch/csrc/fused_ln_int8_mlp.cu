// PreLN MLP sub-block, int8 serving path, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_ln_int8_mlp
// (nova_pointcloud_tpu/ops/pallas/fused_block.py, _mlp_kernel):
//
//   y = x + (q8(relu((q8(LN(x)) @ W1) * sx * s1 + b1)) @ W2) * sx2 * s2 + b2
//
// with both quant sites static (calibrated a_in / a_mid) or per row. The
// weights come K-major: w1t (F, D) and w2t (D, F) row-major.
//
// What bounds it on this card: the two int8 products, 4*M*D*F operations
// (0.28 ms at M=32768, D=1024, F=4096 against the 1979 TOP/s int8 peak);
// the bytes (x and y in bf16, 12 MB of weights) are 16x fewer in time.
// Design: (1) one block per row does LN + quant of x (each row's statistics
// need the whole row: a column tile of the product recomputing them would
// read x once per tile); (2) the int8 product with W1 on the wgmma + TMA GEMM
// (int8_wgmma.cuh), whose epilogue dequantizes, adds b1, applies relu and, on
// the static path, quantizes straight to int8 (per-row quant of the mid row
// needs the whole row's amax first, so the dynamic path writes f32 and (2b) a
// row pass quantizes it); (3) the int8 product with W2 on the same GEMM, whose
// epilogue dequantizes, adds b2 and the residual. The int8 mid row (M x F
// bytes) is the one intermediate that goes through device memory. grid1,
// grid2 and smem_bytes are the caller's launch plan of the two products
// (ops/kernels/fused_block.mlp_plan), checked against the GEMM's own.

#include "int8_wgmma.cuh"

extern "C" int nova_fused_ln_int8_mlp(
    const void* x, int x_bf16, int M, int D, int F,
    const void* ln_w, const void* ln_b, const void* b1, const void* b2, int vec_bf16,
    const int8_t* w1t, const float* s1, const int8_t* w2t, const float* s2,
    const float* a_in, const float* a_mid,
    int8_t* q1, float* sx1, int8_t* q2, float* mid, float* sx2,
    void* y, int grid1, int grid2, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool static_acts = a_in != nullptr;
  if (static_acts != (a_mid != nullptr)) return cudaErrorInvalidValue;
  if (!static_acts && mid == nullptr) return cudaErrorInvalidValue;
  int n_tiles, tiles;
  if (!wg8::plan(M, F, D, grid1, smem_bytes, n_tiles, tiles) ||
      !wg8::plan(M, D, F, grid2, smem_bytes, n_tiles, tiles))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_row_quant(x, x_bf16, M, D, ln_w, ln_b, vec_bf16, a_in, q1, sx1,
                                     stream);
  if (err != cudaSuccess) return err;

  EpiParams e1 = {};
  e1.sx_rows = sx1;
  e1.w_scale = s1;
  e1.bias = b1;
  e1.bias_bf16 = vec_bf16;
  if (static_acts) {
    e1.out_amax = a_mid;
    e1.out = q2;
    err = wg8::launch<EPI_RELU_Q8>(q1, w1t, M, F, D, e1, grid1, smem_bytes, stream);
    if (err != cudaSuccess) return err;
  } else {
    e1.out = mid;
    err = wg8::launch<EPI_RELU_F32>(q1, w1t, M, F, D, e1, grid1, smem_bytes, stream);
    if (err != cudaSuccess) return err;
    err = launch_row_quant(mid, 0, M, F, nullptr, nullptr, 0, nullptr, q2, sx2, stream);
    if (err != cudaSuccess) return err;
  }

  EpiParams e2 = {};
  e2.sx_rows = static_acts ? nullptr : sx2;
  e2.sx_amax = a_mid;
  e2.w_scale = s2;
  e2.bias = b2;
  e2.bias_bf16 = vec_bf16;
  e2.resid = x;
  e2.resid_bf16 = x_bf16;
  e2.out = y;
  e2.out_bf16 = x_bf16;
  return wg8::launch<EPI_RESIDUAL>(q2, w2t, M, D, F, e2, grid2, smem_bytes, stream);
}
