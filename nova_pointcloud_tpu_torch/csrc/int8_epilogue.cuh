// Dequant epilogues of the int8 products, shared by the wgmma GEMM
// (int8_wgmma.cuh), its callers' own kernels and the one-launch diffusion
// block (mma.sync): each thread of either tensor-core layout holds adjacent
// column pairs (col, col + 1) of a row, so every GEMM calls the same code and
// its outputs agree bit for bit (and with the first design's mma.sync GEMM,
// whose code this was).
#pragma once

#include "quant.cuh"

namespace nova {

enum {
  EPI_STORE = 0,
  EPI_RELU_Q8 = 1,
  EPI_RELU_F32 = 2,
  EPI_RESIDUAL = 3,
  EPI_GELU_Q8 = 4,
  EPI_GELU_F32 = 5,
  EPI_SILU_Q8 = 6,
  EPI_SILU_F32 = 7,
  EPI_CAST_BIAS = 8
};

// v = acc * sx[row] * w_scale[col] + bias[col], then per EPI:
//   EPI_STORE      out = v                       (f32 or bf16)
//   EPI_*_Q8       out = q8_static(act(v))       (int8, calibrated out_amax)
//   EPI_*_F32      out = act(v)                  (f32; quantized per row after)
//   EPI_RESIDUAL   out = resid + v               (resid's dtype)
//   EPI_CAST_BIAS  out = cast(cast(acc * sx * w_scale) + cast(bias)), the
//                  cast to the output dtype before the bias is added, in that
//                  dtype (nova_pointcloud_tpu/models/vit.py Attention._int8_proj);
//                  bias may be nullptr (no bias)
// with act relu, gelu (gelu_as) or silu (silu_f).
struct EpiParams {
  const float* sx_rows;  // per-row activation scale, or nullptr and
  const float* sx_amax;  // the calibrated amax of a static quant site
  const float* w_scale;  // (N,) per-output-channel weight scales
  const void* bias;
  int bias_bf16;
  const float* out_amax;  // EPI_*_Q8
  const void* resid;      // EPI_RESIDUAL, (M, N)
  int resid_bf16;
  void* out;
  int out_bf16;
};

template <int EPI>
__device__ __forceinline__ float epi_act(float v) {
  if (EPI == EPI_RELU_Q8 || EPI == EPI_RELU_F32) return fmaxf(v, 0.0f);
  if (EPI == EPI_GELU_Q8 || EPI == EPI_GELU_F32) return gelu_as(v);
  if (EPI == EPI_SILU_Q8 || EPI == EPI_SILU_F32) return silu_f(v);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The row's activation scale: per row, or the static scale of the site.
__device__ __forceinline__ float epi_row_scale(const EpiParams& ep, int row) {
  return ep.sx_rows != nullptr ? ep.sx_rows[row] : static_scale(ep.sx_amax);
}

// 1 / the output site's static scale (EPI_*_Q8), the same for every element
__device__ __forceinline__ float epi_out_inv(const EpiParams& ep) {
  return 1.0f / static_scale(ep.out_amax);
}

// EPI_STORE's, EPI_CAST_BIAS's and EPI_RESIDUAL's two adjacent output
// columns in bf16, given the row's activation scale sx, the columns' weight
// scales and biases and (EPI_RESIDUAL) the residual pair r: the values
// epilogue_sx stores for a bf16 output, for a caller that stores them
// itself (the wgmma GEMM's TMA-store epilogue).
template <int EPI>
__device__ __forceinline__ __nv_bfloat162 epi_bf16_pair(const EpiParams& ep, float sx,
                                                        const float* ws, const float* bs,
                                                        int c0, int c1,
                                                        float2 r = make_float2(0.0f, 0.0f)) {
  static_assert(EPI == EPI_STORE || EPI == EPI_CAST_BIAS || EPI == EPI_RESIDUAL,
                "a bf16 store epilogue");
  if (EPI == EPI_RESIDUAL) {
    const float v0 = static_cast<float>(c0) * sx * ws[0] + bs[0];
    const float v1 = static_cast<float>(c1) * sx * ws[1] + bs[1];
    return __floats2bfloat162_rn(r.x + v0, r.y + v1);
  }
  if (EPI == EPI_CAST_BIAS) {
    float v0 = round_bf16(static_cast<float>(c0) * sx * ws[0]);
    float v1 = round_bf16(static_cast<float>(c1) * sx * ws[1]);
    if (ep.bias != nullptr) {
      v0 = v0 + round_bf16(bs[0]);
      v1 = v1 + round_bf16(bs[1]);
    }
    return __floats2bfloat162_rn(v0, v1);
  }
  return __floats2bfloat162_rn(static_cast<float>(c0) * sx * ws[0] + bs[0],
                               static_cast<float>(c1) * sx * ws[1] + bs[1]);
}

// Two adjacent output columns (col, col + 1) of one row, given the row's
// activation scale sx, for EPI_*_Q8 out_inv = epi_out_inv(ep), and for
// EPI_RESIDUAL the residual pair r (so a caller can load or compute them
// ahead); ws / bs are the columns' weight scales and biases.
template <int EPI>
__device__ __forceinline__ void epilogue_sx(const EpiParams& ep, int N, int row, int col,
                                            float sx, float out_inv, const float* ws,
                                            const float* bs, int c0, int c1, float2 r) {
  constexpr bool kQ8 = EPI == EPI_RELU_Q8 || EPI == EPI_GELU_Q8 || EPI == EPI_SILU_Q8;
  constexpr bool kF32 = EPI == EPI_RELU_F32 || EPI == EPI_GELU_F32 || EPI == EPI_SILU_F32;
  const long o = static_cast<long>(row) * N + col;
  if (EPI == EPI_CAST_BIAS || EPI == EPI_STORE) {
    if (ep.out_bf16) {
      *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(ep.out) + o) =
          epi_bf16_pair<(EPI == EPI_STORE ? EPI_STORE : EPI_CAST_BIAS)>(ep, sx, ws, bs, c0, c1);
      return;
    }
    float v0 = static_cast<float>(c0) * sx * ws[0];
    float v1 = static_cast<float>(c1) * sx * ws[1];
    if (EPI == EPI_STORE || ep.bias != nullptr) {
      v0 = v0 + bs[0];
      v1 = v1 + bs[1];
    }
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(ep.out) + o) = make_float2(v0, v1);
    return;
  }
  const float v0 = static_cast<float>(c0) * sx * ws[0] + bs[0];
  const float v1 = static_cast<float>(c1) * sx * ws[1] + bs[1];
  if (kQ8) {
    char2 q;
    q.x = q8_rint(epi_act<EPI>(v0) * out_inv);
    q.y = q8_rint(epi_act<EPI>(v1) * out_inv);
    *reinterpret_cast<char2*>(reinterpret_cast<int8_t*>(ep.out) + o) = q;
  } else if (kF32) {
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(ep.out) + o) =
        make_float2(epi_act<EPI>(v0), epi_act<EPI>(v1));
  } else if (ep.out_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(ep.out) + o) =
        epi_bf16_pair<EPI_RESIDUAL>(ep, sx, ws, bs, c0, c1, r);
  } else {
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(ep.out) + o) =
        make_float2(r.x + v0, r.y + v1);
  }
}

}  // namespace nova
