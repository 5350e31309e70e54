// Tiled int8 x int8 -> int32 matrix product with fused dequant epilogues:
// the first design's GEMM, whose last caller is int8_matmul_residual (the
// other kernels run their products on int8_wgmma.cuh).
//
// C[M, N] = A[M, K] @ W[K, N], with A int8 row-major (activations) and the
// weights given K-major, as Wt[N, K] row-major (the port pre-quantizes them
// so: ops/quantization.py). Tensor cores via mma.sync m16n8k32 s8 with int32
// accumulation, so the product is exact.
//
// Block tile 128x128x128, 8 warps (2 x 4), warp tile 64x32. Both operands
// stream through a 3-stage cp.async ring in shared memory (rows padded by 16
// bytes: ldmatrix is conflict-free), fragments are loaded with ldmatrix.
// Measured on the H100 against a 1-stage, in-kernel-transpose first cut and
// 128x256 / 4-stage / BK=64 variants (PERF.md). A first design: no TMA,
// no wgmma.
#pragma once

#include "int8_epilogue.cuh"
#include "tensor_core.cuh"

namespace nova {

constexpr int GBM = 128, GBN = 128, GBK = 128, GSTAGES = 3;
constexpr int GLD = GBK + 16;  // padded smem row (bytes)
constexpr int GSTAGE_BYTES = (GBM + GBN) * GLD;
constexpr int GSMEM_BYTES = GSTAGES * GSTAGE_BYTES;  // 110592: dynamic shared memory

// Requires N % 128 == 0, K % 128 == 0 (checked by the host launcher).
template <int EPI>
__global__ void __launch_bounds__(256)
    gemm_s8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Wt, int M,
                   int N, int K, EpiParams ep) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int ktiles = K / GBK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // each stage: A rows [0, 128) then W rows [128, 256), GBK bytes of K
  // each, copied 16 bytes at a time
  constexpr int CPR = GBK / 16;  // 16-byte chunks per row
  auto load_stage = [&](int stage, int kt) {
    int8_t* s = smem + stage * GSTAGE_BYTES;
    const int k0 = kt * GBK;
#pragma unroll
    for (int i = 0; i < GBM * CPR / 256; ++i) {
      const int c = tid + i * 256, r = c / CPR, col = (c % CPR) * 16;
      const int gm = m0 + r;
      const bool ok = gm < M;
      cp_async16(s + r * GLD + col, A + static_cast<long>(ok ? gm : 0) * K + k0 + col, ok);
      cp_async16(s + (GBM + r) * GLD + col, Wt + static_cast<long>(n0 + r) * K + k0 + col,
                 true);
    }
  };

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  // ldmatrix row / column of this lane within a 16x32-byte A block and a
  // 16(n)x32-byte W block (two n8 tiles)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // stage kt landed; everyone is done with stage kt-1
    const int pre = kt + GSTAGES - 1;
    if (pre < ktiles) load_stage(pre % GSTAGES, pre);
    cp_async_commit();

    const int8_t* As = smem + (kt % GSTAGES) * GSTAGE_BYTES;
    const int8_t* Bs = As + GBM * GLD;
#pragma unroll
    for (int ks = 0; ks < GBK; ks += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], As + (wm * 64 + mi * 16 + a_row) * GLD + ks + a_col);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];
        ldmatrix_x4(r, Bs + (wn * 32 + nj * 16 + b_row) * GLD + ks + b_col);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + tig * 2;
    const float ws[2] = {ep.w_scale[col], ep.w_scale[col + 1]};
    const float bs[2] = {ep.bias != nullptr ? ld_any(ep.bias, col, ep.bias_bf16) : 0.0f,
                         ep.bias != nullptr ? ld_any(ep.bias, col + 1, ep.bias_bf16) : 0.0f};
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
        if (row < M)
          epilogue<EPI>(ep, N, row, col, ws, bs, acc[mi][ni][half * 2],
                        acc[mi][ni][half * 2 + 1]);
      }
  }
}

template <int EPI>
inline cudaError_t launch_gemm_s8(const int8_t* A, const int8_t* Wt, int M, int N, int K,
                                  const EpiParams& ep, cudaStream_t stream) {
  if (N % GBN != 0 || K % GBK != 0 || M <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_s8_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         GSMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_s8_kernel<EPI><<<grid, 256, GSMEM_BYTES, stream>>>(A, Wt, M, N, K, ep);
  return cudaGetLastError();
}

}  // namespace nova
