// int8 x int8 -> int32 matrix product for Hopper (sm_90a) on wgmma and TMA,
// with the dequant epilogues of int8_epilogue.cuh.
//
// C[M, N] = A[M, K] @ W[K, N], A int8 row-major (activations), the weights
// K-major as Wt[N, K] row-major: both operands K-major, the only layout of
// 8-bit wgmma, and the one the port stores (ops/quantization.py). The int32
// sums are exact, and the epilogue is the code the mma.sync GEMM runs
// (int8_gemm.cuh), so both GEMMs give the same outputs bit for bit.
//
// What bounds it on this card: at the serving shapes the products (2 M N K
// operations against the 1979 TOP/s int8 peak); the bytes from device
// memory are a few times fewer in time, but each tile step reads 48 KB from
// L2 for 8.4 M operations, and that rate, not the tensor cores', is what
// the main loop meets (PERF.md). Design:
//   - tile 128 x 256 (m x n), k-steps of 128 bytes; two consumer warpgroups
//     of 64 rows, each one wgmma m64n256k32 s8 per 32 bytes of k, so a
//     tile's A rows are read once for 256 columns;
//   - A and W tiles by TMA (2-D maps, 128B swizzle, rows past M or N read as
//     zeros) into a ring of STAGES stages, each with a full and an empty
//     mbarrier; one thread of a producer warpgroup keeps the copies in
//     flight, and setmaxnreg moves its registers to the consumers (each
//     holds a 64 x 256 int32 accumulator, 128 registers a thread);
//   - a persistent grid, one block an SM, walking the output tiles with n
//     fastest (the blocks that run together share A rows, and W stays in
//     L2): while the consumers run one tile's epilogue, the producer is
//     already loading the next tile's stages;
//   - the two consumers share no barrier but the stages' (each stages its
//     own copy of the tile's column scales and biases), so they may drift
//     apart as far as the ring lets them (one named barrier for both
//     measured the same: chip_int8_probe.py);
//   - what the epilogue reads is asked for before the tile's products: the
//     column scales and biases (two a thread, staged in shared memory after
//     the products), the rows' activation scales, and the residual rows
//     (prefetched into L2, then loaded JB column groups at a time), so the
//     epilogue waits for no load from device memory; the int8 output's
//     1 / scale is computed once, not per element (its two IEEE divisions
//     per element cost a fifth of the kernel at 32768 rows);
//   - the main loop waits for at most one wgmma group (the stage before the
//     one just issued) before releasing that stage; its first and last
//     steps are peeled, so no wait or accumulate flag is chosen at run time
//     (ptxas serializes every wgmma of a loop that does: its C7514 note).
// The ring, the producer's stage loads and a consumer's products (Ring) are
// also the main loop of row 5's fc2 + post-LN kernel
// (fused_int8_mlp_postln.cu), which walks the tiles by cluster.
#pragma once

#include "hopper.cuh"
#include "int8_epilogue.cuh"

namespace nova {
namespace wg8 {

constexpr int BM = 128, BN = 256, BK = 128, STAGES = 4;
constexpr int CONSUMERS = 2;                     // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int A_BYTES = BM * BK;                 // 16 KB
constexpr int W_BYTES = BN * BK;                 // 32 KB
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int OFF_BAR = STAGES * STAGE_BYTES;    // full[s], then empty[s]
constexpr int OFF_EPI = OFF_BAR + 2 * STAGES * 8;  // each consumer's column scales, biases
constexpr int EPI_BYTES = 2 * BN * 4;
constexpr int SMEM = OFF_EPI + CONSUMERS * EPI_BYTES + 1024;  // + 1024 to align the tiles
constexpr int JB = 4;  // 8-column groups whose residuals the epilogue loads at once
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// The ring of STAGES stages (an A tile and a W tile each) with a full and
// an empty mbarrier a stage, as the producer and each consumer walk it.
struct Ring {
  uint32_t base, full, empty;
  int s;
  uint32_t phase;
  __device__ __forceinline__ explicit Ring(uint32_t b)
      : base(b), full(b + OFF_BAR), empty(b + OFF_BAR + STAGES * 8), s(0), phase(0) {}
  __device__ __forceinline__ void advance() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  // by one thread, before the block's first barrier
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the producer: the k-stages of output tile (mt, nt)
  __device__ __forceinline__ void load_tile(const CUtensorMap* tm_a, const CUtensorMap* tm_w,
                                            int mt, int nt, int ktiles) {
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(empty + 8 * s, phase ^ 1);  // a fresh barrier passes parity 1
      const uint32_t dst = base + s * STAGE_BYTES;
      mbar_expect_tx(full + 8 * s, STAGE_BYTES);
      tma_load_2d(dst, tm_a, full + 8 * s, kt * BK, mt * BM);
      tma_load_2d(dst + A_BYTES, tm_w, full + 8 * s, kt * BK, nt * BN);
      advance();
    }
  }
  // consumer warpgroup c: one tile's products into its 64 x 256 int32
  // accumulator, each stage released once read. The loop waits for at most
  // one wgmma group (the stage before the one just issued); its first and
  // last steps are peeled, so no wait or accumulate flag is chosen at run
  // time.
  __device__ __forceinline__ void products(int (&acc)[128], int ktiles, int c, int lane) {
    auto issue = [&](int slot, bool first) {
      const uint64_t da = desc_sw128(base + slot * STAGE_BYTES + c * 64 * BK, false);
      const uint64_t dw = desc_sw128(base + slot * STAGE_BYTES + A_BYTES, false);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8_n256(acc, da + 2 * kk, dw + 2 * kk, !first || kk > 0);
      wgmma_commit();
    };
    auto release = [&](int slot) {
      if (lane == 0) mbar_arrive(empty + 8 * slot);
    };
    mbar_wait(full + 8 * s, phase);
    wgmma_fence();
    issue(s, true);
    int prev = s;
    advance();
    for (int kt = 1; kt < ktiles; ++kt) {
      mbar_wait(full + 8 * s, phase);
      issue(s, false);
      wgmma_wait<1>();  // the stage before this one is read
      release(prev);
      prev = s;
      advance();
    }
    wgmma_wait<0>();
    release(prev);
    fence_regs(acc);
  }
};

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_s8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_w, int M, int N, int n_tiles,
                         int tiles, int ktiles, const EpiParams ep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warp-uniform
  Ring ring(base);
  if (tid == 0) ring.init();
  __syncthreads();

  if (wg == 0) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile / n_tiles;
        ring.load_tile(&tm_a, &tm_w, mt, tile - mt * n_tiles, ktiles);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1, lt = tid & 127, warp = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warpgroup's copy of the tile's column scales and biases: the two
  // consumers share no barrier but the stages', so one's epilogue runs
  // while the other's products do
  const uint32_t s_ws = base + OFF_EPI + c * EPI_BYTES, s_bs = s_ws + BN * 4;
  constexpr bool kQ8 = EPI == EPI_RELU_Q8 || EPI == EPI_GELU_Q8 || EPI == EPI_SILU_Q8;
  const float out_inv = kQ8 ? epi_out_inv(ep) : 0.0f;
  int acc[128];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / n_tiles, nt = tile - mt * n_tiles;
    // accumulator element i: row 16 warp + g + 8 ((i >> 1) & 1), column
    // 8 (i >> 2) + 2 t + (i & 1) of this warpgroup's 64 x 256
    const int row0 = mt * BM + 64 * c + 16 * warp + g, n0 = nt * BN;
    // what the epilogue reads, loaded while the products run: two columns'
    // scales and biases a thread (staged in shared memory below), the two
    // rows' activation scales, and the warpgroup's residual rows into L2
    float my_ws[2], my_bs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tcol = n0 + lt + 128 * h;
      my_ws[h] = tcol < N ? ep.w_scale[tcol] : 0.0f;
      my_bs[h] = tcol < N && ep.bias != nullptr ? ld_any(ep.bias, tcol, ep.bias_bf16) : 0.0f;
    }
    const float sx0 = row0 < M ? epi_row_scale(ep, row0) : 0.0f;
    const float sx1 = row0 + 8 < M ? epi_row_scale(ep, row0 + 8) : 0.0f;
    if (EPI == EPI_RESIDUAL) {  // row lt / 2 of the 64, its half lt % 2, in 128-byte lines
      const int r = mt * BM + 64 * c + (lt >> 1), half_bytes = BN * (ep.resid_bf16 ? 2 : 4) / 2;
      if (r < M) {
        const char* p = static_cast<const char*>(ep.resid) +
                        (static_cast<long>(r) * N + n0) * (ep.resid_bf16 ? 2 : 4) +
                        (lt & 1) * half_bytes;
        for (int off = 0; off < half_bytes; off += 128)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
      }
    }

    ring.products(acc, ktiles, c, lane);

    named_sync(1 + c, 128);  // this warpgroup's last epilogue has read the staged columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sts_u32(s_ws + 4 * (lt + 128 * h), __float_as_uint(my_ws[h]));
      sts_u32(s_bs + 4 * (lt + 128 * h), __float_as_uint(my_bs[h]));
    }
    named_sync(1 + c, 128);
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += JB) {
      float2 r[JB][2];  // the residual pairs of JB column groups, loaded together
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half, col = n0 + 8 * (j0 + jj) + 2 * t;
          r[jj][half] = make_float2(0.0f, 0.0f);
          if (EPI == EPI_RESIDUAL && row < M && col < N) {
            const long o = static_cast<long>(row) * N + col;
            const void* rp = ep.resid_bf16 ? static_cast<const void*>(
                                                 static_cast<const __nv_bfloat16*>(ep.resid) + o)
                                           : static_cast<const void*>(
                                                 static_cast<const float*>(ep.resid) + o);
            r[jj][half] = ep.resid_bf16
                              ? __bfloat1622float2(*static_cast<const __nv_bfloat162*>(rp))
                              : *static_cast<const float2*>(rp);
          }
        }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const int j = j0 + jj, col = n0 + 8 * j + 2 * t;
        if (col >= N) continue;
        const float2 w2 = lds_f2(s_ws + 4 * (8 * j + 2 * t));
        const float2 b2 = lds_f2(s_bs + 4 * (8 * j + 2 * t));
        const float ws[2] = {w2.x, w2.y}, bs[2] = {b2.x, b2.y};
        if (row0 < M)
          epilogue_sx<EPI>(ep, N, row0, col, sx0, out_inv, ws, bs, acc[4 * j], acc[4 * j + 1],
                           r[jj][0]);
        if (row0 + 8 < M)
          epilogue_sx<EPI>(ep, N, row0 + 8, col, sx1, out_inv, ws, bs, acc[4 * j + 2],
                           acc[4 * j + 3], r[jj][1]);
      }
    }
  }
}

// The launch plan's checks (the wrapper computes the plan: ops/kernels/
// fused_block.gemm_plan): N a multiple of 128 (the epilogue writes column
// pairs of whole 8-column groups), K of BK, 1 <= grid <= tiles.
inline bool plan(int M, int N, int K, int grid, int smem_bytes, int& n_tiles, int& tiles) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 128 != 0 || K % BK != 0) return false;
  n_tiles = (N + BN - 1) / BN;
  const long all = static_cast<long>((M + BM - 1) / BM) * n_tiles;
  if (all > 2147483647L) return false;
  tiles = static_cast<int>(all);
  return grid >= 1 && grid <= tiles && smem_bytes == SMEM;
}

template <int EPI>
inline cudaError_t launch(const int8_t* A, const int8_t* Wt, int M, int N, int K,
                          const EpiParams& ep, int grid, int smem_bytes, cudaStream_t stream) {
  int n_tiles, tiles;
  if (!plan(M, N, K, grid, smem_bytes, n_tiles, tiles)) return cudaErrorInvalidConfiguration;
  CUtensorMap maps[2];
  if (!kmajor_map(&maps[0], A, M, K, BM) || !kmajor_map(&maps[1], Wt, N, K, BN))
    return cudaErrorInvalidValue;
  auto kernel = gemm_s8_wgmma_kernel<EPI>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, SMEM, stream>>>(maps[0], maps[1], M, N, n_tiles, tiles, K / BK, ep);
  return cudaGetLastError();
}

}  // namespace wg8
}  // namespace nova
