// One AdaLN-zero diffusion-head block, int8 serving path, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_int8_diffusion_block
// (nova_pointcloud_tpu/ops/pallas/fused_block.py, _diffusion_block_kernel):
//
//   (scale | shift | gate) = q8(silu(zc)) @ Ws * sz * ss + bs      (M, 3D)
//   h = LN(x) * (1 + scale) + shift                                LN eps 1e-6, no affine
//   a = silu(q8(h) @ W1 * sh * s1 + b1)
//   o = q8(a) @ W2 * sa * s2 + b2
//   y = (LN(o) * n2_w + n2_b) * gate + x                           norm2 eps from the caller
//
// with the three quant sites static (calibrated a_z / a_h / a_silu) or per
// row. Weights come K-major: wst (3D, D), w1t (D, D), w2t (D, D) row-major.
//
// What bounds it on this card: bytes. The three int8 weights are 5*D*D bytes
// (5.2 MB at D=1024, 1.6 us at 3.35 TB/s); at the serving shape (M = 200 rows:
// batch 4 x CFG 2 x 25 predicted tokens) the products are 2.1 GOP (1.1 us at
// the int8 peak). A row-blocked kernel
// like the TPU's (block_m = 256) would put one or two blocks on 132 SMs, so the
// function is split into launches that spread over the output columns:
// (1) row pass silu(zc) -> int8; (2) stats GEMM (N = 3D, f32 out);
// (3) row pass AdaLN-modulate -> int8; (4) fc1 GEMM with a silu epilogue
// (int8 out when static, f32 + (4b) a row quant pass when per row); (5) fc2
// GEMM (f32 out); (6) row pass norm2 * gate + x. Launch latency, not the
// card's rates, sets its time: CUDA graphs are the next step.

#include "int8_gemm.cuh"

extern "C" int nova_fused_int8_diffusion_block(
    const void* x, int x_bf16, const void* zc, int zc_bf16, int M, int D,
    const void* bs, const void* b1, const void* b2, const void* n2_w, const void* n2_b,
    int vec_bf16, float n2_eps,
    const int8_t* wst, const float* ss, const int8_t* w1t, const float* s1,
    const int8_t* w2t, const float* s2,
    const float* a_z, const float* a_h, const float* a_silu,
    int8_t* qz, float* sz, float* stats, int8_t* qh, float* sh, int8_t* qa, float* mid,
    float* sa, float* o, void* y, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool static_acts = a_z != nullptr;
  if (static_acts != (a_h != nullptr) || static_acts != (a_silu != nullptr))
    return cudaErrorInvalidValue;
  if (!static_acts && mid == nullptr) return cudaErrorInvalidValue;

  RowParams rz = {};
  rz.x = zc;
  rz.x_bf16 = zc_bf16;
  rz.K = D;
  rz.amax_static = a_z;
  rz.q = qz;
  rz.sx = sz;
  cudaError_t err = launch_row_op<ROW_SILU_QUANT>(rz, M, stream);
  if (err != cudaSuccess) return err;

  EpiParams es = {};
  es.sx_rows = sz;
  es.w_scale = ss;
  es.bias = bs;
  es.bias_bf16 = vec_bf16;
  es.out = stats;
  es.out_bf16 = 0;
  err = launch_gemm_s8<EPI_STORE>(qz, wst, M, 3 * D, D, es, stream);
  if (err != cudaSuccess) return err;

  RowParams rh = {};
  rh.x = x;
  rh.x_bf16 = x_bf16;
  rh.K = D;
  rh.eps = kLnEps;
  rh.amax_static = a_h;
  rh.q = qh;
  rh.sx = sh;
  rh.mod = stats;
  rh.mod_ld = 3 * D;
  err = launch_row_op<ROW_ADALN_QUANT>(rh, M, stream);
  if (err != cudaSuccess) return err;

  EpiParams e1 = {};
  e1.sx_rows = sh;
  e1.w_scale = s1;
  e1.bias = b1;
  e1.bias_bf16 = vec_bf16;
  if (static_acts) {
    e1.out_amax = a_silu;
    e1.out = qa;
    err = launch_gemm_s8<EPI_SILU_Q8>(qh, w1t, M, D, D, e1, stream);
    if (err != cudaSuccess) return err;
  } else {
    e1.out = mid;
    err = launch_gemm_s8<EPI_SILU_F32>(qh, w1t, M, D, D, e1, stream);
    if (err != cudaSuccess) return err;
    err = launch_row_quant(mid, 0, M, D, nullptr, nullptr, 0, nullptr, qa, sa, stream);
    if (err != cudaSuccess) return err;
  }

  EpiParams e2 = {};
  e2.sx_rows = static_acts ? nullptr : sa;
  e2.sx_amax = a_silu;
  e2.w_scale = s2;
  e2.bias = b2;
  e2.bias_bf16 = vec_bf16;
  e2.out = o;
  e2.out_bf16 = 0;
  err = launch_gemm_s8<EPI_STORE>(qa, w2t, M, D, D, e2, stream);
  if (err != cudaSuccess) return err;

  RowParams ry = {};
  ry.x = o;
  ry.x_bf16 = 0;
  ry.K = D;
  ry.ln_w = n2_w;
  ry.ln_b = n2_b;
  ry.vec_bf16 = vec_bf16;
  ry.eps = n2_eps;
  ry.mod = stats + 2 * D;
  ry.mod_ld = 3 * D;
  ry.res = x;
  ry.res_bf16 = x_bf16;
  ry.y = y;
  ry.y_bf16 = x_bf16;
  return launch_row_op<ROW_POSTLN_GATE>(ry, M, stream);
}
