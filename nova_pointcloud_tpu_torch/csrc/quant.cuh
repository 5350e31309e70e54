// Shared int8 quantization helpers for the fused serving kernels.
//
// Numerics follow nova_pointcloud_tpu (ops/quantization.py and
// ops/pallas/fused_block.py) bit for bit in rounding:
//   - per-row (dynamic) quant DIVIDES:        q = clip(rint(x / s), +-127),
//     s = max(amax_row / 127, 1e-8)           (quantize_activations)
//   - static quant MULTIPLIES by 1/s:         q = clip(rint(x * (1 / s)), +-127),
//     s = max(amax_calibrated / 127, 1e-8)    (_quant_static)
//   - rint is round-half-to-even (jnp.round), never roundf.
// Built with -fmad=false so a*b+c rounds twice, as the reference does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nova {

constexpr float kLnEps = 1e-6f;  // flax nn.LayerNorm default, used by the pc blocks

// x / (1 + exp(-x)), as fused_block._silu
__device__ __forceinline__ float silu_f(float x) { return x / (1.0f + expf(-x)); }

// exact-erf gelu with erf by Abramowitz-Stegun 7.1.26 (max error 1.5e-7), the
// polynomial of fused_block._erf, so kernel and plain version quantize the
// same values: 0.5 * x * (1 + erf(x / sqrt(2)))
__device__ __forceinline__ float gelu_as(float x) {
  const float z = x * 0.70710678118654752f;
  const float sgn = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  const float az = fabsf(z);
  const float t = 1.0f / (1.0f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf = sgn * (1.0f - poly * expf(-az * az));
  return 0.5f * x * (1.0f + erf);
}

__device__ __forceinline__ float ld_any(const void* p, long i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_any(void* p, long i, float v, int bf16) {
  if (bf16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// s = max(amax / 127, 1e-8) from a calibrated amax held on the device
__device__ __forceinline__ float static_scale(const float* amax) {
  return fmaxf(__ldg(amax) / 127.0f, 1e-8f);
}

__device__ __forceinline__ int8_t q8_rint(float v) {
  float r = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum or max over the block (blockDim.x a multiple of 32). red: shared float[33].
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float r = lane < nw ? red[lane] : (is_max ? -INFINITY : 0.0f);
    r = is_max ? warp_max(r) : warp_sum(r);
    if (lane == 0) red[32] = r;
  }
  __syncthreads();
  return red[32];
}

// One block of 128 threads per row of x (M, K), the row held in registers
// (MAXV values a thread, K <= 128 * MAXV; launch_row_quant takes it for
// K <= 1024 and row_op_kernel below for wider rows): optional LayerNorm (two-pass
// mean/var, eps 1e-6, as fused_block._ln), then int8 quantization of the
// row, static when amax_static is given, else per row. Writes q (M, K) and
// the row scale sx (M).
constexpr int kRowThreads = 128;

template <int MAXV>
__global__ void __launch_bounds__(kRowThreads)
    row_quant_kernel(const void* __restrict__ x, int x_bf16, int K,
                     const void* __restrict__ ln_w, const void* __restrict__ ln_b,
                     int vec_bf16, const float* __restrict__ amax_static,
                     int8_t* __restrict__ q, float* __restrict__ sx) {
  __shared__ float red[33];
  const long base = static_cast<long>(blockIdx.x) * K;
  float v[MAXV];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int k = threadIdx.x + i * kRowThreads;
    v[i] = k < K ? ld_any(x, base + k, x_bf16) : 0.0f;
  }
  if (ln_w != nullptr) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) s += v[i];
    const float mu = block_reduce(s, red, false) / static_cast<float>(K);
    float d2 = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = threadIdx.x + i * kRowThreads;
      const float d = v[i] - mu;
      d2 += k < K ? d * d : 0.0f;
    }
    const float var = block_reduce(d2, red, false) / static_cast<float>(K);
    const float rstd = 1.0f / sqrtf(var + kLnEps);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int k = threadIdx.x + i * kRowThreads;
      if (k < K)
        v[i] = (v[i] - mu) * rstd * ld_any(ln_w, k, vec_bf16) + ld_any(ln_b, k, vec_bf16);
    }
  }
  float s_row, mul = 1.0f;
  const bool is_static = amax_static != nullptr;
  if (is_static) {
    s_row = static_scale(amax_static);
    mul = 1.0f / s_row;
  } else {
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) m = fmaxf(m, fabsf(v[i]));  // padding is 0
    s_row = fmaxf(block_reduce(m, red, true) / 127.0f, 1e-8f);
  }
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int k = threadIdx.x + i * kRowThreads;
    if (k < K) q[base + k] = q8_rint(is_static ? v[i] * mul : v[i] / s_row);
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = s_row;
}

// The rows without LayerNorm, one warp a row (kQuantRows rows a block), for
// K <= kQuantMaxK a multiple of 16 and x, q at 16-byte boundaries: chunk j
// of 16 elements (64 bytes of f32, 32 of bf16) goes to lane j % 32, loaded
// 16 bytes at a time, and its 16 codes go out as one 16-byte store; the
// amax is a warp reduction (exact in any order), and the quant is the row
// kernel's (divide by s_row, or multiply by 1 / s for a static site), so
// the codes and scales are row_quant_kernel's bit for bit. Rows as
// short-lived 128-thread blocks of scalar loads and byte stores took about
// half the byte rate (PERF.md).
constexpr int kQuantRows = 8;
constexpr int kQuantMaxK = 1024;
constexpr int kQuantChunks = kQuantMaxK / (16 * 32);  // a lane's chunks at most

template <bool BF16>
__global__ void __launch_bounds__(32 * kQuantRows)
    row_quant_warp_kernel(const void* __restrict__ x, int M, int K,
                          const float* __restrict__ amax_static, int8_t* __restrict__ q,
                          float* __restrict__ sx) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kQuantRows + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp
  const int chunks = K / 16;
  float v[kQuantChunks][16];
#pragma unroll
  for (int c = 0; c < kQuantChunks; ++c) {
    const int j = lane + 32 * c;
    if (j < chunks) {
      const long at = row * K + 16 * j;
      if (BF16) {
        const uint4* src = reinterpret_cast<const uint4*>(
            reinterpret_cast<const __nv_bfloat16*>(x) + at);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 u = __ldg(src + h);
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[c][8 * h + 2 * e] = __uint_as_float(w[e] << 16);
            v[c][8 * h + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
          }
        }
      } else {
        const float4* src = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + at);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 f = __ldg(src + h);
          v[c][4 * h] = f.x;
          v[c][4 * h + 1] = f.y;
          v[c][4 * h + 2] = f.z;
          v[c][4 * h + 3] = f.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) v[c][e] = 0.0f;
    }
  }
  float s_row, mul = 1.0f;
  const bool is_static = amax_static != nullptr;
  if (is_static) {
    s_row = static_scale(amax_static);
    mul = 1.0f / s_row;
  } else {
    float m = 0.0f;
#pragma unroll
    for (int c = 0; c < kQuantChunks; ++c)
#pragma unroll
      for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(v[c][e]));  // padding is 0
    s_row = fmaxf(warp_max(m) / 127.0f, 1e-8f);
  }
#pragma unroll
  for (int c = 0; c < kQuantChunks; ++c) {
    const int j = lane + 32 * c;
    if (j >= chunks) continue;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t b = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float f = v[c][4 * e + i];
        const int8_t code = q8_rint(is_static ? f * mul : f / s_row);
        b |= static_cast<uint32_t>(static_cast<uint8_t>(code)) << (8 * i);
      }
      w[e] = b;
    }
    *reinterpret_cast<uint4*>(q + row * K + 16 * j) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (lane == 0) sx[row] = s_row;
}

// Rows of any width, the row staged in shared memory (K floats) instead of
// registers: one block of 256 threads per row of x (M, K) (row_op_kernel),
// or, called as a device function, one warp per row (the one-launch
// diffusion block). OP selects what happens to the row (each thread reads
// and writes only its own elements, k = tid + i * NT, so only the
// reductions synchronise):
//   ROW_QUANT         [LN_affine(x)] -> int8 q, row scale sx (static or per row)
//   ROW_SILU_QUANT    silu(x) -> int8                      (diffusion cond z)
//   ROW_POSTLN_GATE   y = LN_affine(x) * gate + x_res      (gated residual)
// LayerNorm is two-pass (mean, then mean of squared deviations), as
// fused_block._ln, with the eps given.
enum { ROW_QUANT = 0, ROW_SILU_QUANT = 1, ROW_POSTLN_GATE = 4 };
constexpr int kRowOpThreads = 256;
constexpr int kRowOpMaxK = 56 * 1024;  // K floats of dynamic shared memory, under 227 KB

struct RowParams {
  const void* x;
  int x_bf16, K;
  const void* ln_w;  // affine LN params (ROW_QUANT: nullptr = no LN)
  const void* ln_b;
  int vec_bf16;
  float eps;
  const float* amax_static;  // quant ops: calibrated amax, or nullptr = per row
  int8_t* q;
  float* sx;
  const float* mod;  // ROW_POSTLN_GATE: the gate, at [0, K) of each row of a
  int mod_ld;        // (M, mod_ld) f32 matrix
  const void* res;   // ROW_POSTLN_GATE: the residual (M, K)
  int res_bf16;
  void* y;
  int y_bf16;
};

// Sum or max over the NT threads that share a row: one warp (NT = 32,
// shuffles only; red unused) or the block (red: shared float[33]).
template <int NT>
__device__ __forceinline__ float group_reduce(float v, float* red, bool is_max) {
  if constexpr (NT == 32) return is_max ? warp_max(v) : warp_sum(v);
  return block_reduce(v, red, is_max);
}

// Row `row` by the NT threads tid = 0 .. NT - 1; srow: K floats of shared
// memory of this group's own. The loops that read device memory issue U
// loads a thread before they use any (a warp's row is 32 values a thread at
// K = 1024).
template <int OP, int NT, int U = 8>
__device__ __forceinline__ void row_op(const RowParams& p, long row, float* srow, float* red,
                                       int tid) {
  const int K = p.K;
  const long base = row * K;
  const float* mod = p.mod != nullptr ? p.mod + row * p.mod_ld : nullptr;
  for (int k0 = tid; k0 < K; k0 += U * NT) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * NT;
      v[u] = k < K ? ld_any(p.x, base + k, p.x_bf16) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * NT;
      if (k < K) srow[k] = OP == ROW_SILU_QUANT ? silu_f(v[u]) : v[u];
    }
  }
  const bool ln = OP != ROW_SILU_QUANT && (OP != ROW_QUANT || p.ln_w != nullptr);
  if (ln) {
    float s = 0.0f;
    for (int k = tid; k < K; k += NT) s += srow[k];
    const float mu = group_reduce<NT>(s, red, false) / static_cast<float>(K);
    float d2 = 0.0f;
    for (int k = tid; k < K; k += NT) {
      const float d = srow[k] - mu;
      d2 += d * d;
    }
    const float var = group_reduce<NT>(d2, red, false) / static_cast<float>(K);
    const float rstd = 1.0f / sqrtf(var + p.eps);
    for (int k0 = tid; k0 < K; k0 += U * NT) {
      float w[U], b[U], res[U], gate[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * NT;
        const bool in = k < K;
        w[u] = in ? ld_any(p.ln_w, k, p.vec_bf16) : 0.0f;
        b[u] = in ? ld_any(p.ln_b, k, p.vec_bf16) : 0.0f;
        res[u] = in && OP != ROW_QUANT ? ld_any(p.res, base + k, p.res_bf16) : 0.0f;
        gate[u] = in && OP == ROW_POSTLN_GATE ? mod[k] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * NT;
        if (k >= K) continue;
        float v = (srow[k] - mu) * rstd;
        v = v * w[u] + b[u];
        if (OP == ROW_POSTLN_GATE) {
          st_any(p.y, base + k, v * gate[u] + res[u], p.y_bf16);
        } else {
          srow[k] = v;
        }
      }
    }
  }
  if (OP == ROW_POSTLN_GATE) return;
  float s_row, mul = 1.0f;
  const bool is_static = p.amax_static != nullptr;
  if (is_static) {
    s_row = static_scale(p.amax_static);
    mul = 1.0f / s_row;
  } else {
    float m = 0.0f;
    for (int k = tid; k < K; k += NT) m = fmaxf(m, fabsf(srow[k]));
    s_row = fmaxf(group_reduce<NT>(m, red, true) / 127.0f, 1e-8f);
  }
  for (int k = tid; k < K; k += NT)
    p.q[base + k] = q8_rint(is_static ? srow[k] * mul : srow[k] / s_row);
  if (tid == 0) p.sx[row] = s_row;
}

template <int OP>
__global__ void __launch_bounds__(kRowOpThreads) row_op_kernel(RowParams p) {
  extern __shared__ float srow[];
  __shared__ float red[33];
  row_op<OP, kRowOpThreads>(p, blockIdx.x, srow, red, threadIdx.x);
}

template <int OP>
inline cudaError_t launch_row_op(const RowParams& p, int M, cudaStream_t stream) {
  if (M <= 0 || p.K <= 0 || p.K > kRowOpMaxK) return cudaErrorInvalidValue;
  const int smem = p.K * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(row_op_kernel<OP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  row_op_kernel<OP><<<M, kRowOpThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// LN (eps 1e-6, when ln_w is given) + int8 quant of each row. Rows of up to
// 1024 values are held in registers: without LN one warp a row
// (row_quant_warp_kernel, for K a multiple of 16 and 16-byte-aligned x and
// q), else one block a row (row_quant_kernel); wider rows are staged in
// shared memory (row_op_kernel), so K has no practical limit.
inline cudaError_t launch_row_quant(const void* x, int x_bf16, int M, int K,
                                    const void* ln_w, const void* ln_b, int vec_bf16,
                                    const float* amax_static, int8_t* q, float* sx,
                                    cudaStream_t stream) {
  if (ln_w == nullptr && K <= kQuantMaxK && K % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    const int blocks = (M + kQuantRows - 1) / kQuantRows;
    if (x_bf16)
      row_quant_warp_kernel<true><<<blocks, 32 * kQuantRows, 0, stream>>>(x, M, K, amax_static,
                                                                          q, sx);
    else
      row_quant_warp_kernel<false><<<blocks, 32 * kQuantRows, 0, stream>>>(x, M, K, amax_static,
                                                                           q, sx);
    return cudaGetLastError();
  }
  if (K <= 8 * kRowThreads) {
    row_quant_kernel<8><<<M, kRowThreads, 0, stream>>>(x, x_bf16, K, ln_w, ln_b, vec_bf16,
                                                       amax_static, q, sx);
    return cudaGetLastError();
  }
  RowParams p = {};
  p.x = x;
  p.x_bf16 = x_bf16;
  p.K = K;
  p.ln_w = ln_w;
  p.ln_b = ln_b;
  p.vec_bf16 = vec_bf16;
  p.eps = kLnEps;
  p.amax_static = amax_static;
  p.q = q;
  p.sx = sx;
  return launch_row_op<ROW_QUANT>(p, M, stream);
}

}  // namespace nova

// Message for an error code returned by a library's entry point.
extern "C" const char* nova_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
