// int8 x int8 -> int32 matrix product for Hopper (sm_90a) on wgmma and TMA,
// with the dequant epilogues of int8_epilogue.cuh.
//
// C[M, N] = A[M, K] @ W[K, N], A int8 row-major (activations), the weights
// K-major as Wt[N, K] row-major: both operands K-major, the only layout of
// 8-bit wgmma, and the one the port stores (ops/quantization.py). The int32
// sums are exact, and the epilogue is the code the first design's mma.sync
// GEMM ran, so both give the same outputs bit for bit.
//
// What bounds it on this card: at the serving shapes the products (2 M N K
// operations against the 1979 TOP/s int8 peak); the bytes from device
// memory are a few times fewer in time, but each tile step reads 48 KB from
// L2 for 8.4 M operations, and that rate, not the tensor cores', is what
// the main loop meets (PERF.md). Design:
//   - tile 128 x TN (m x n), TN = 256, or 128 where the plan finds that a
//     narrower tile fills the last wave of a few waves better (its A tile
//     is read for half the columns: fused_block.store_plan); k-steps of 128
//     bytes; two
//     consumer warpgroups of 64 rows, each one wgmma m64nTNk32 s8 per 32
//     bytes of k, so a tile's A rows are read once for TN columns;
//   - A and W tiles by TMA (2-D maps, 128B swizzle, rows past M or N read as
//     zeros) into a ring of STAGES stages, each with a full and an empty
//     mbarrier; one thread of a producer warpgroup keeps the copies in
//     flight, and setmaxnreg moves its registers to the consumers (each
//     holds a 64 x TN int32 accumulator, TN / 2 registers a thread);
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
//   - a bf16 output of EPI_STORE or EPI_CAST_BIAS (TMA_OUT) goes out
//     through shared memory: each consumer writes its 64 x TN tile there in
//     the 128B swizzle (no bank conflicts) and one thread stores it by TMA,
//     so the next tile's products start while it is written; stored from
//     the registers instead (8 rows x 16 bytes a warp instruction, after
//     the products and overlapping nothing), it took 30-40% of int8_linear
//     and row 3 (PERF.md). The output tiles take the room of a stage at TN
//     = 256 (3 stages). EPI_RESIDUAL with a bf16 residual and output
//     (TMA_OUT) loads the tile's residual rows by TMA into that tile as
//     its products start, adds the product in place and stores the sum by
//     TMA: loaded by the threads after the products, JB column groups at a
//     time, the residual's L2 round trips took a sixth of row 4 (PERF.md);
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
constexpr int JB = 4;  // 8-column groups whose residuals the epilogue loads at once
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// The shared memory of output tiles BM x TN: the ring's NS stages (an A
// tile and a TN x BK W tile each), a full and an empty mbarrier a stage,
// each consumer's TN column scales and biases; with TMA_OUT (a bf16 output
// stored by TMA) an mbarrier a consumer for its residual tile's load and
// each consumer's 64 x TN bf16 output tile, as TN / 64 boxes of 64 rows x
// 128 bytes in the 128B swizzle, at a 1024-byte boundary (so 3 stages at
// TN = 256, to fit); 1024 bytes to align the tiles.
template <int TN, bool TMA_OUT = false>
struct Layout {
  static_assert(TN == 256 || TN == 128, "wgmma s8 tiles of 256 or 128 columns");
  static constexpr int NS = TMA_OUT && TN == 256 ? 3 : STAGES;
  static constexpr int W_BYTES = TN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  static constexpr int OFF_BAR = NS * STAGE_BYTES;      // full[s], then empty[s]
  static constexpr int OFF_RES_BAR = OFF_BAR + 2 * NS * 8;  // TMA_OUT: a consumer's residual
  static constexpr int OFF_EPI = OFF_RES_BAR + (TMA_OUT ? CONSUMERS * 8 : 0);  // scales, biases
  static constexpr int EPI_BYTES = 2 * TN * 4;
  static constexpr int OFF_OUT = (OFF_EPI + CONSUMERS * EPI_BYTES + 1023) / 1024 * 1024;
  static constexpr int OUT_BYTES = 64 * TN * 2;  // a consumer's bf16 output tile
  static constexpr int SMEM =
      (TMA_OUT ? OFF_OUT + CONSUMERS * OUT_BYTES : OFF_EPI + CONSUMERS * EPI_BYTES) + 1024;
};
constexpr int OFF_BAR = Layout<BN>::OFF_BAR;  // the mbarriers of 256-wide tiles' ring

// The ring of L::NS stages (an A tile and a TN-row W tile each) with a full
// and an empty mbarrier a stage, as the producer and each consumer walk it.
template <int TN, bool TMA_OUT = false>
struct RingT {
  using L = Layout<TN, TMA_OUT>;
  uint32_t base, full, empty;
  int s;
  uint32_t phase;
  __device__ __forceinline__ explicit RingT(uint32_t b)
      : base(b), full(b + L::OFF_BAR), empty(b + L::OFF_BAR + L::NS * 8), s(0), phase(0) {}
  __device__ __forceinline__ void advance() {
    if (++s == L::NS) {
      s = 0;
      phase ^= 1;
    }
  }
  // by one thread, before the block's first barrier
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < L::NS; ++i) {
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
      const uint32_t dst = base + s * L::STAGE_BYTES;
      mbar_expect_tx(full + 8 * s, L::STAGE_BYTES);
      tma_load_2d(dst, tm_a, full + 8 * s, kt * BK, mt * BM);
      tma_load_2d(dst + A_BYTES, tm_w, full + 8 * s, kt * BK, nt * TN);
      advance();
    }
  }
  // consumer warpgroup c: one tile's products into its 64 x TN int32
  // accumulator, each stage released once read. The loop waits for at most
  // one wgmma group (the stage before the one just issued); its first and
  // last steps are peeled, so no wait or accumulate flag is chosen at run
  // time.
  __device__ __forceinline__ void products(int (&acc)[TN / 2], int ktiles, int c, int lane) {
    auto issue = [&](int slot, bool first) {
      const uint64_t da = desc_sw128(base + slot * L::STAGE_BYTES + c * 64 * BK, false);
      const uint64_t dw = desc_sw128(base + slot * L::STAGE_BYTES + A_BYTES, false);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        if constexpr (TN == 256)
          wgmma_s8_n256(acc, da + 2 * kk, dw + 2 * kk, !first || kk > 0);
        else
          wgmma_s8_n128(acc, da + 2 * kk, dw + 2 * kk, !first || kk > 0);
      }
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
using Ring = RingT<BN>;

// TMA_OUT: EPI_STORE, EPI_CAST_BIAS or EPI_RESIDUAL with a bf16 output,
// stored through shared memory by TMA (tm_out) while the next tile's
// products run; EPI_RESIDUAL's bf16 residual loaded into that shared memory
// by TMA (tm_res) while the tile's products run.
template <int EPI, int TN, bool TMA_OUT>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_s8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_out,
                         const __grid_constant__ CUtensorMap tm_res, int M, int N, int n_tiles,
                         int tiles, int ktiles, const EpiParams ep) {
  static_assert(!TMA_OUT || EPI == EPI_STORE || EPI == EPI_CAST_BIAS || EPI == EPI_RESIDUAL,
                "a bf16 store epilogue");
  constexpr bool kTmaRes = TMA_OUT && EPI == EPI_RESIDUAL;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warp-uniform
  using L = Layout<TN, TMA_OUT>;
  RingT<TN, TMA_OUT> ring(base);
  if (tid == 0) {
    if (kTmaRes)
      for (int c = 0; c < CONSUMERS; ++c) mbar_init(base + L::OFF_RES_BAR + 8 * c, 1);
    ring.init();  // (its fence covers these barriers too)
  }
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
  const uint32_t s_ws = base + L::OFF_EPI + c * L::EPI_BYTES, s_bs = s_ws + TN * 4;
  constexpr bool kQ8 = EPI == EPI_RELU_Q8 || EPI == EPI_GELU_Q8 || EPI == EPI_SILU_Q8;
  constexpr int H = TN / 128;  // columns a thread stages
  const float out_inv = kQ8 ? epi_out_inv(ep) : 0.0f;
  int acc[TN / 2];
  const uint32_t out_s = base + L::OFF_OUT + c * L::OUT_BYTES;  // TMA_OUT
  const uint32_t res_bar = base + L::OFF_RES_BAR + 8 * c;       // kTmaRes
  uint32_t res_phase = 0;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mt = tile / n_tiles, nt = tile - mt * n_tiles;
    if (kTmaRes && lt == 0) {
      // the residual's 64 x TN tile into the output tile, once TMA has read
      // the last tile's output from it (rows past M, columns past N: zeros)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      mbar_expect_tx(res_bar, L::OUT_BYTES);
#pragma unroll
      for (int b = 0; b < TN / 64; ++b)
        tma_load_2d(out_s + b * 8192, &tm_res, res_bar, nt * TN + 64 * b, mt * BM + 64 * c);
    }
    // accumulator element i: row 16 warp + g + 8 ((i >> 1) & 1), column
    // 8 (i >> 2) + 2 t + (i & 1) of this warpgroup's 64 x TN
    const int row0 = mt * BM + 64 * c + 16 * warp + g, n0 = nt * TN;
    // what the epilogue reads, loaded while the products run: H columns'
    // scales and biases a thread (staged in shared memory below), the two
    // rows' activation scales, and the warpgroup's residual rows into L2
    float my_ws[H], my_bs[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int tcol = n0 + lt + 128 * h;
      my_ws[h] = tcol < N ? ep.w_scale[tcol] : 0.0f;
      my_bs[h] = tcol < N && ep.bias != nullptr ? ld_any(ep.bias, tcol, ep.bias_bf16) : 0.0f;
    }
    const float sx0 = row0 < M ? epi_row_scale(ep, row0) : 0.0f;
    const float sx1 = row0 + 8 < M ? epi_row_scale(ep, row0 + 8) : 0.0f;
    if (EPI == EPI_RESIDUAL && !kTmaRes) {  // row lt / 2 of the 64, its half lt % 2, in 128-byte lines
      const int r = mt * BM + 64 * c + (lt >> 1), half_bytes = TN * (ep.resid_bf16 ? 2 : 4) / 2;
      if (r < M) {
        const char* p = static_cast<const char*>(ep.resid) +
                        (static_cast<long>(r) * N + n0) * (ep.resid_bf16 ? 2 : 4) +
                        (lt & 1) * half_bytes;
        for (int off = 0; off < half_bytes; off += 128)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
      }
    }

    ring.products(acc, ktiles, c, lane);

    // this warpgroup's last epilogue has read the staged columns, and TMA
    // its staged output
    if (TMA_OUT && lt == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    named_sync(1 + c, 128);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      sts_u32(s_ws + 4 * (lt + 128 * h), __float_as_uint(my_ws[h]));
      sts_u32(s_bs + 4 * (lt + 128 * h), __float_as_uint(my_bs[h]));
    }
    named_sync(1 + c, 128);
    if constexpr (TMA_OUT) {
      // the bf16 pairs into the warpgroup's output tile: 8-column group j
      // of row r is 16-byte chunk j % 8 of box j / 8's row r, at chunk
      // (j % 8) ^ (r % 8) (the 128B swizzle: a warp's stores hit 32 banks),
      // each pair added to the residual's there (EPI_RESIDUAL), then TMA
      // stores the boxes (rows past M, columns past N dropped)
      const int r = 16 * warp + g;
      if (kTmaRes) {
        mbar_wait(res_bar, res_phase);
        res_phase ^= 1;
      }
#pragma unroll
      for (int j0 = 0; j0 < TN / 8; j0 += 8) {
        // the residual pairs of 8 column groups first (volatile loads keep
        // their order: loaded one by one, each would wait behind the stores)
        unsigned ru[8][2];
#pragma unroll
        for (int jj = 0; jj < 8 && kTmaRes; ++jj) {
          const int j = j0 + jj;
          const uint32_t off = (j >> 3) * 8192 + r * 128 + (((j & 7) ^ g) << 4) + 4 * t;
          ru[jj][0] = lds_u32(out_s + off);
          ru[jj][1] = lds_u32(out_s + off + 8 * 128);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj;
          const float2 w2 = lds_f2(s_ws + 4 * (8 * j + 2 * t));
          const float2 b2 = lds_f2(s_bs + 4 * (8 * j + 2 * t));
          const float ws[2] = {w2.x, w2.y}, bs[2] = {b2.x, b2.y};
          const uint32_t off = (j >> 3) * 8192 + r * 128 + (((j & 7) ^ g) << 4) + 4 * t;
          float2 r0 = make_float2(0.0f, 0.0f), r1 = r0;
          if (kTmaRes) {
            r0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ru[jj][0]));
            r1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ru[jj][1]));
          }
          const __nv_bfloat162 v0 =
              epi_bf16_pair<EPI>(ep, sx0, ws, bs, acc[4 * j], acc[4 * j + 1], r0);
          const __nv_bfloat162 v1 =
              epi_bf16_pair<EPI>(ep, sx1, ws, bs, acc[4 * j + 2], acc[4 * j + 3], r1);
          sts_u32(out_s + off, *reinterpret_cast<const unsigned*>(&v0));
          sts_u32(out_s + off + 8 * 128, *reinterpret_cast<const unsigned*>(&v1));
        }
      }
      fence_proxy_async();  // the stores above, seen by TMA
      named_sync(1 + c, 128);
      if (lt == 0) {
#pragma unroll
        for (int b = 0; b < TN / 64; ++b)
          tma_store_2d(&tm_out, out_s + b * 8192, n0 + 64 * b, mt * BM + 64 * c);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      continue;
    }
#pragma unroll
    for (int j0 = 0; j0 < TN / 8; j0 += JB) {
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
  // the block's shared memory stays until TMA has written the last tile
  if (TMA_OUT && lt == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The launch plan's checks (the wrapper computes the plan: ops/kernels/
// fused_block.gemm_plan): N a multiple of 128 (the epilogue writes column
// pairs of whole 8-column groups), K of BK, 1 <= grid <= tiles, the shared
// memory of tiles TN wide (with the TMA-store output tiles if TMA_OUT).
template <int TN = BN, bool TMA_OUT = false>
inline bool plan(int M, int N, int K, int grid, int smem_bytes, int& n_tiles, int& tiles) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 128 != 0 || K % BK != 0) return false;
  n_tiles = (N + TN - 1) / TN;
  const long all = static_cast<long>((M + BM - 1) / BM) * n_tiles;
  if (all > 2147483647L) return false;
  tiles = static_cast<int>(all);
  return grid >= 1 && grid <= tiles && smem_bytes == Layout<TN, TMA_OUT>::SMEM;
}

// A 2-D map over a bf16 output or residual (M, N) row-major: boxes of 64
// columns (128 bytes) by 64 rows, 128B swizzle (the layout the TMA_OUT
// epilogue stages).
inline bool out_map(CUtensorMap* m, const void* ptr, int M, int N) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || N % 8 != 0) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
  cuuint32_t box[2] = {64, 64};
  cuuint32_t elem[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int EPI, int TN = BN, bool TMA_OUT = false>
inline cudaError_t launch(const int8_t* A, const int8_t* Wt, int M, int N, int K,
                          const EpiParams& ep, int grid, int smem_bytes, cudaStream_t stream) {
  int n_tiles, tiles;
  if (!plan<TN, TMA_OUT>(M, N, K, grid, smem_bytes, n_tiles, tiles))
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[4] = {};
  if (!kmajor_map(&maps[0], A, M, K, BM) || !kmajor_map(&maps[1], Wt, N, K, TN))
    return cudaErrorInvalidValue;
  if (TMA_OUT && (!ep.out_bf16 || !out_map(&maps[2], ep.out, M, N)))
    return cudaErrorInvalidValue;
  if (TMA_OUT && EPI == EPI_RESIDUAL && (!ep.resid_bf16 || !out_map(&maps[3], ep.resid, M, N)))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<TN, TMA_OUT>::SMEM;
  auto kernel = gemm_s8_wgmma_kernel<EPI, TN, TMA_OUT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], M, N, n_tiles,
                                          tiles, K / BK, ep);
  return cudaGetLastError();
}

// EPI_STORE or EPI_CAST_BIAS as the plan laid it out: tiles block_n (256 or
// 128) wide, a bf16 output stored by TMA (tma_out) or by the threads.
template <int EPI>
inline cudaError_t launch_store(int block_n, int tma_out, const int8_t* A, const int8_t* Wt,
                                int M, int N, int K, const EpiParams& ep, int grid,
                                int smem_bytes, cudaStream_t stream) {
  static_assert(EPI == EPI_STORE || EPI == EPI_CAST_BIAS, "a store epilogue");
  if (tma_out != ep.out_bf16) return cudaErrorInvalidConfiguration;
  if (block_n == 256)
    return tma_out ? launch<EPI, 256, true>(A, Wt, M, N, K, ep, grid, smem_bytes, stream)
                   : launch<EPI, 256, false>(A, Wt, M, N, K, ep, grid, smem_bytes, stream);
  if (block_n == 128)
    return tma_out ? launch<EPI, 128, true>(A, Wt, M, N, K, ep, grid, smem_bytes, stream)
                   : launch<EPI, 128, false>(A, Wt, M, N, K, ep, grid, smem_bytes, stream);
  return cudaErrorInvalidConfiguration;
}

// plan<TN, TMA_OUT> for the tile width block_n.
inline bool plan_store(int block_n, int tma_out, int M, int N, int K, int grid, int smem_bytes) {
  int n_tiles, tiles;
  if (block_n == 256)
    return tma_out ? plan<256, true>(M, N, K, grid, smem_bytes, n_tiles, tiles)
                   : plan<256, false>(M, N, K, grid, smem_bytes, n_tiles, tiles);
  if (block_n == 128)
    return tma_out ? plan<128, true>(M, N, K, grid, smem_bytes, n_tiles, tiles)
                   : plan<128, false>(M, N, K, grid, smem_bytes, n_tiles, tiles);
  return false;
}

}  // namespace wg8
}  // namespace nova
