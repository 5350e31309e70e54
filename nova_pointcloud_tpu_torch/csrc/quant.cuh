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
// (MAXV values a thread, K <= 128 * MAXV): optional LayerNorm (two-pass
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

inline cudaError_t launch_row_quant(const void* x, int x_bf16, int M, int K,
                                    const void* ln_w, const void* ln_b, int vec_bf16,
                                    const float* amax_static, int8_t* q, float* sx,
                                    cudaStream_t stream) {
  if (K <= 8 * kRowThreads)
    row_quant_kernel<8><<<M, kRowThreads, 0, stream>>>(x, x_bf16, K, ln_w, ln_b, vec_bf16,
                                                       amax_static, q, sx);
  else if (K <= 32 * kRowThreads)
    row_quant_kernel<32><<<M, kRowThreads, 0, stream>>>(x, x_bf16, K, ln_w, ln_b, vec_bf16,
                                                        amax_static, q, sx);
  else if (K <= 64 * kRowThreads)
    row_quant_kernel<64><<<M, kRowThreads, 0, stream>>>(x, x_bf16, K, ln_w, ln_b, vec_bf16,
                                                        amax_static, q, sx);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace nova

// Message for an error code returned by a library's entry point.
extern "C" const char* nova_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
