// Post-norm int8 MLP sub-block of the NOVA ViT block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_int8_mlp_postln
// (nova_pointcloud_tpu/ops/pallas/fused_block.py, _mlp_postln_kernel):
//
//   a = gelu(q8(x) @ W1 * sx * s1 + b1)            exact-erf gelu (A-S polynomial)
//   o = q8(a) @ W2 * sa * s2 + b2
//   y = x + LN(o) * ln_w + ln_b                    LN eps from the caller (1e-5)
//
// with both quant sites static (calibrated a_x / a_gelu: multiply by 1/s) or
// per row (divide by the row's amax / 127). The weights come K-major: w1t (F, D)
// and w2t (D, F) row-major.
//
// What bounds it on this card: the two int8 products, 4*M*D*F operations
// (0.087 ms at M=10240, D=1024, F=4096 against the 1979 TOP/s int8 peak); its
// bytes (x in, y out, 8 MB of weights) take a fifth of that. Design: four
// launches (five on the per-row path). (1) the row pass quantizes x; (2) the
// shared int8 GEMM with W1 whose epilogue dequantizes, adds b1, applies gelu
// and, on the static path, quantizes to int8 (per-row quant of the 4096-wide
// mid row needs the whole row's amax first, so the per-row path writes f32 and
// (2b) a shared-memory row pass quantizes it); (3) the GEMM with W2, whose
// epilogue writes the f32 product; (4) a row pass does the post-LN of each
// 1024-wide product row, which the GEMM's 128-column tiles cannot see whole,
// and adds the residual. The int8 mid row and the f32 product row are the
// intermediates that go through device memory.

#include "int8_gemm.cuh"

extern "C" int nova_fused_int8_mlp_postln(
    const void* x, int x_bf16, int M, int D, int F,
    const void* b1, const void* b2, const void* ln_w, const void* ln_b, int vec_bf16,
    float ln_eps, const int8_t* w1t, const float* s1, const int8_t* w2t, const float* s2,
    const float* a_x, const float* a_gelu,
    int8_t* q1, float* sx1, int8_t* q2, float* mid, float* sx2, float* o,
    void* y, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool static_acts = a_x != nullptr;
  if (static_acts != (a_gelu != nullptr)) return cudaErrorInvalidValue;
  if (!static_acts && mid == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_row_quant(x, x_bf16, M, D, nullptr, nullptr, 0, a_x, q1, sx1,
                                     stream);
  if (err != cudaSuccess) return err;

  EpiParams e1 = {};
  e1.sx_rows = sx1;
  e1.w_scale = s1;
  e1.bias = b1;
  e1.bias_bf16 = vec_bf16;
  if (static_acts) {
    e1.out_amax = a_gelu;
    e1.out = q2;
    err = launch_gemm_s8<EPI_GELU_Q8>(q1, w1t, M, F, D, e1, stream);
    if (err != cudaSuccess) return err;
  } else {
    e1.out = mid;
    err = launch_gemm_s8<EPI_GELU_F32>(q1, w1t, M, F, D, e1, stream);
    if (err != cudaSuccess) return err;
    err = launch_row_quant(mid, 0, M, F, nullptr, nullptr, 0, nullptr, q2, sx2, stream);
    if (err != cudaSuccess) return err;
  }

  EpiParams e2 = {};
  e2.sx_rows = static_acts ? nullptr : sx2;
  e2.sx_amax = a_gelu;
  e2.w_scale = s2;
  e2.bias = b2;
  e2.bias_bf16 = vec_bf16;
  e2.out = o;
  e2.out_bf16 = 0;
  err = launch_gemm_s8<EPI_STORE>(q2, w2t, M, D, F, e2, stream);
  if (err != cudaSuccess) return err;

  RowParams r = {};
  r.x = o;
  r.x_bf16 = 0;
  r.K = D;
  r.ln_w = ln_w;
  r.ln_b = ln_b;
  r.vec_bf16 = vec_bf16;
  r.eps = ln_eps;
  r.res = x;
  r.res_bf16 = x_bf16;
  r.y = y;
  r.y_bf16 = x_bf16;
  return launch_row_op<ROW_POSTLN_RESID>(r, M, stream);
}
