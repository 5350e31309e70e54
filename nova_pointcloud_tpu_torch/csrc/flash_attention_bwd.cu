// Flash attention, backward, for Hopper (sm_90a).
//
// Replaces the backward of flash_attention in
// nova_pointcloud_tpu/ops/pallas/flash_attention.py (_flash_bwd: delta in
// XLA, the dK/dV kernel at the pallas_call of _bwd_dkv_kernel and the dQ
// kernel at the pallas_call of _bwd_dq_kernel), the flash recomputation from
// the forward's saved log-sum-exp:
//
//   p     = exp(q k^T / sqrt(d) + bias - lse)      (recomputed, never stored)
//   dv    = p^T do
//   ds    = p * (do v^T - delta) / sqrt(d),  delta = sum(do * o) per row
//   dk    = ds^T q,   dq = ds k                   f32 sums, in the input dtype
//
// bf16 runs in one pass and three kernels:
//   prep:  delta = sum(do * o) per query row in f32 from the saved o, in the
//          JAX function's order on the CPU (two sequential halves of 32,
//          then their sum; no contraction), and lse; both as (B*H, Lqp) rows
//          padded to a multiple of 128 (delta 0, lse 1e30), lse in units of
//          log 2 for the bf16 kernel. One thread per row.
//   dkvq:  one block per (key tile of 128, batch*head): two warpgroups of 64
//          keys each, and no producer warp, so that a thread may hold 255
//          registers. Each warpgroup runs alone: its thread 0 loads the
//          warpgroup's K and V once by TMA (128B-swizzled, 64 bf16 = one
//          row) and streams query tiles of 64 rows of q and do through the
//          warpgroup's own two-stage TMA ring with mbarriers, lse and delta
//          beside them by bulk copy. K and V go into registers as wgmma A
//          fragments (ldmatrix). Per query tile, all on wgmma (m64n64k16, f32
//          accumulators): S^T = K Q^T and dP^T = V dO^T (A from registers),
//          P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q (A from
//          registers, B transposed in shared memory), and the warpgroup's
//          part of dQ = dS K with dS stored to shared memory as two bf16
//          tiles, hi = bf16(ds) and lo = bf16(ds - hi) (a row of ds sums to
//          0, so dq is the small rest of keys that share a large common
//          part, and one rounding of ds would be large against it), read
//          transposed. The dQ part goes through a 128B-swizzled f32 buffer
//          into an f32 workspace (B*H, Lqp, 64) by TMA reduce-add
//          (cp.reduce.async.bulk.tensor .add), one per 64 x 32 box; dK and dV
//          are written once at the end. dK takes dS as hi alone, dV takes p
//          rounded to bf16, as the forward rounds p. The softmax scale (a
//          power of 2) is left out of ds and put on dk at the end and on dq
//          in the cast. A full bias gets its own instance of the kernel.
//   cast:  the f32 dq workspace times the scale -> dq in bf16, in its
//          strided layout.
// The atomic dQ sums run in no fixed order: dq may differ in its last bits
// from run to run; dk and dv do not.
//
// bf16 at head dim 96 (the NOVA-1.4B ViTs) runs one pass, in three
// kernels: prep as above (two halves of 48), then
//   dkvq96: one block of two warpgroups of 64 keys each per (key tile of
//          128, batch*head), 256 threads of up to 255 registers. K and V
//          once and query tiles of q and do of 64 rows through a
//          three-stage TMA ring, every tile three 32-column panels in the
//          64B swizzle. Per query tile a warpgroup computes S^T = K Q^T and
//          dP^T = V dO^T (m64n64k16 from shared memory), P^T and dS^T in
//          registers, dV += P^T dO and dK += dS^T Q (m64n96k16, A from
//          registers; 48 + 48 accumulators a thread, held over the pass),
//          stores dS^T as hi and lo bf16 tiles and computes its part of dQ =
//          dS K over its own 64 keys (m64n96k16, both from shared memory).
//          Warpgroup 0 stores its part in an f32 buffer (two, alternating),
//          warpgroup 1 adds its own to it, and one of its threads adds the
//          sum into an f32 workspace (B*H, Lqp, 96) by TMA reduce-add in a
//          fixed order (below). Only that sum couples the warpgroups, so one's
//          element work runs beside the other's products. dK and dV are
//          written once. (A producer warpgroup with setmaxnreg, or a
//          producer warp, left ptxas fewer registers than the warpgroups
//          need: they spilled and their wgmma were serialized; splitting dQ
//          between the warpgroups by columns made them wait on each other's
//          dS every tile.)
//   cast:  the workspace times the scale -> dq in bf16, as at 64.
// The pass computes S and dP once: 12 B*H*Lq*Lk*d FLOPs with the lo product
// (the TPU kernels' split, ported first, took 16).
//
// The dQ sums at head dim 96 (bf16 and f32) take a fixed order, so dq is
// bitwise repeatable (as dk and dv): a block takes its (key tile, b*h) from
// an atomic ticket when it starts, key tiles fastest; for each (query tile,
// b*h) an int32 turn counter in a zeroed workspace. The block of key tile kt
// waits until the counter reads kt (one thread, an acquire load), adds its
// part by TMA reduce-add, waits for the add to complete and stores kt + 1
// (release). Every block walks the query tiles in the same order, so after
// a start-up stagger of about a handoff a key tile the waits are short; a
// block waits only on blocks with lower tickets, which have started, so no
// count of resident blocks can deadlock it (FlashAttention-3's
// deterministic backward does the same).
//
// f32 runs in one pass too, in f32 FFMA (no TF32: this route is the
// exactness check of the training step), in two kernels:
//   prep:  as above, lse in natural units;
//   f32:   one block of 128 threads per (key tile of 64, batch*head): K and
//          V of its keys and each streamed query tile (q, do by TMA, lse and
//          delta by bulk copy) in shared memory as 128B-swizzled f32 boxes.
//          Per query tile five register-tiled 64 x 64 x 64 products, each
//          value loaded from shared memory feeding four to eight FFMAs:
//          S^T = K Q^T and dP^T = V dO^T (two groups of 64 threads, each
//          32 keys, a thread 4 x 8 of each), P^T and dS^T (the scale folded
//          in) of a thread's elements in registers, then through shared
//          memory dV += P^T dO and dK += dS^T Q side by side (a thread
//          8 x 8), then dQ = dS K by all 128 threads (a thread 4 x 8),
//          added into the zeroed f32 dq by TMA reduce-add
//          (cp.reduce.async.bulk.tensor) while the next tile is computed. s
//          and dp are computed once (the first design's two SIMT kernels,
//          one thread a row, computed both twice and read an operand of
//          every FFMA from shared memory).
//
// f32 at head dim 96 (the NOVA-1.4B ViTs) runs one pass too, in two
// kernels: prep as above (two halves of 48, natural units), then
//   f32_96: one block of 256 threads per (key tile of 64, batch*head), K and
//          V once and the query tiles through a two-stage ring, every tile
//          three 128-byte boxes a row in f32_chunk's layout. Per query tile
//          S^T and dP^T by all 256 threads (4 x 4 each), P and dS (the scale
//          folded in) to shared memory, dV += P^T dO (warps 0-3) and dK +=
//          dS^T Q (warps 4-7), 4 x 12 accumulators a thread, then the dQ part
//          dS K by all 256 threads (4 x 6 each, in the registers S^T and dP^T
//          held), staged in its own buffer and added into the zeroed f32 dq
//          by TMA reduce-add in the fixed order above. The hd-64 one-pass
//          kernel's 8 x 8 dV / dK a thread would be 8 x 12 here beside S^T
//          and dP^T (it spills), hence 256 threads and a kernel of its own.
// 10 B*H*Lq*Lk*d FLOPs (the split ported first computed S and dP twice: 14).
//
// q, k, v, do, dq, dk, dv are (B, H, L, d) views given by their batch / head /
// row strides with d contiguous (16-byte multiples), so the model's
// (B, L, H, d) layouts are read and written in place; the TMA maps are 4-D
// (d, L, H, B) over those strides. Ragged tails: TMA fills keys past Lk with
// zeros and they get p = 0 from a -inf key term; query rows past Lq load as
// zeros with lse 1e30. bias: none, a key bias (B, Lk) read with the batch
// index bh / H, or a full bias (Lq, Lk) read transposed (the consumer holds
// S^T); -inf entries and rows with lse 1e30 give p = 0 without inf - inf.
// Biases get no gradient (the JAX VJP declares their cotangent zero).
//
// The TMA descriptors are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint: the library links no -lcuda.
// The mbarrier, TMA, descriptor and wgmma helpers and the map encoder are
// hopper.cuh's, shared with the forward kernels.
//
// What bounds it on this card: operations. The function does 10 B*H*Lq*Lk*d
// FLOPs (s, do v^T, p^T do, ds^T q, ds k), 12 with the lo product: 0.136 ms
// at B*H = 128, L = 1280, d = 64 against the 989 TFLOP/s bf16 peak, against
// about 0.05 ms for the bytes. wgmma is the only path to that rate; one pass
// computes s and dp once (the split of the TPU kernels computed both twice).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): dkvq
// 0.42 ms at that shape, 12 units at about 380 TFLOP/s. Each warpgroup's
// steps wait on each other (products, then exp and dS, then products; a
// clock64 breakdown per tile, in PERF.md), so the tensor cores idle while
// both warpgroups do element work. In f32 the same 10 B*H*Lq*Lk*d FLOPs
// take at least 2.00 ms at 67 TFLOP/s (f32 FFMA); two blocks of the f32
// kernel share an SM (99856 bytes of shared memory each, 254 registers a
// thread): 3.42 ms, 58.5% of that bound, SDPA's f32 backward 4.18 ms
// (PERF.md; the dQ product is its weakest step).

#include "hopper.cuh"

#include "quant.cuh"

namespace nova {

constexpr float kBwdLog2e = 1.4426950408889634f;
constexpr float kDeadLse = 1e30f;  // lse of a row with every key masked, and of padding

struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*H, Lqp), natural log, 1e30 on dead and padded rows
  const float* delta;  // (B*H, Lqp), 0 on padded rows
  const float* kbias;  // (B, Lk) or nullptr
  const float* fbias;  // (Lq, Lk) or nullptr
  void* dq;
  void* dk;
  void* dv;
  long q_sb, q_sh, q_sl;  // strides in elements: batch, head, row
  long k_sb, k_sh, k_sl;
  long v_sb, v_sh, v_sl;
  long o_sb, o_sh, o_sl;  // do
  long dq_sb, dq_sh, dq_sl;
  long dk_sb, dk_sh, dk_sl;
  long dv_sb, dv_sh, dv_sl;
  int H, Lq, Lk, Lqp;
  float scale;
};

constexpr int BHD = 64;        // head dim of the hd-64 one-pass kernels (bf16 dkvq, f32)
constexpr int LQ_PAD = 128;    // lse / delta rows are padded to a multiple of this

// ---------------------------------------------------------------------------
// prep: delta and lse rows
// ---------------------------------------------------------------------------
constexpr int PREP_THREADS = 128;

// 16 bytes of a row as f32: 4 floats or 8 bf16
__device__ __forceinline__ void load16(const float* r, int i, float* x) {
  const float4 v = reinterpret_cast<const float4*>(r)[i];
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* r, int i, float* x) {
  const uint4 v = reinterpret_cast<const uint4*>(r)[i];
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u[j]);
    x[2 * j] = __low2float(h);
    x[2 * j + 1] = __high2float(h);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(PREP_THREADS)
    flash_bwd_prep_kernel(const T* o, const T* dout, const float* lse, int H, int Lq, int Lqp,
                          long o_sb, long o_sh, long o_sl, long d_sb, long d_sh, long d_sl,
                          float lse_mul, float* lse_out, float* delta_out, long rows) {
  constexpr int PER = 16 / sizeof(T);  // values per 16-byte load
  const long i = static_cast<long>(blockIdx.x) * PREP_THREADS + threadIdx.x;
  if (i >= rows) return;
  const int bh = static_cast<int>(i / Lqp), row = static_cast<int>(i % Lqp);
  if (row >= Lq) {
    lse_out[i] = kDeadLse;
    delta_out[i] = 0.0f;
    return;
  }
  const int b = bh / H, h = bh % H;
  const T* orow = o + b * o_sb + h * o_sh + row * o_sl;
  const T* drow = dout + b * d_sb + h * d_sh + row * d_sl;
  // XLA's order on the CPU: each half of D / 2 summed in sequence from 0,
  // then the two halves; __fmul_rn / __fadd_rn keep nvcc from contracting to fma
  float half[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < D / PER; ++c) {
    float x[PER], y[PER];
    load16(orow, c, x);
    load16(drow, c, y);
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      float& acc = half[(c * PER + e) / (D / 2)];
      acc = __fadd_rn(acc, __fmul_rn(y[e], x[e]));
    }
  }
  delta_out[i] = __fadd_rn(__fadd_rn(0.0f, half[0]), half[1]);
  lse_out[i] = __fmul_rn(lse[static_cast<long>(bh) * Lq + row], lse_mul);
}

// ---------------------------------------------------------------------------
// cast: f32 dq workspace (B*H, Lqp, D) -> bf16 dq (strided), times the
// softmax scale the dkvq kernels leave out of ds (D = 64 or 96)
// ---------------------------------------------------------------------------
constexpr int CAST_THREADS = 256;

template <int D>
__global__ void __launch_bounds__(CAST_THREADS)
    flash_bwd_dq_cast_kernel(const float* ws, int H, int Lq, int Lqp, long sb, long sh, long sl,
                             float scale, __nv_bfloat16* dq, long chunks) {
  const long i = static_cast<long>(blockIdx.x) * CAST_THREADS + threadIdx.x;
  if (i >= chunks) return;  // one chunk: 8 values of one row
  const long r = i / (D / 8);
  const int c = static_cast<int>(i % (D / 8)) * 8;
  const int bh = static_cast<int>(r / Lq), row = static_cast<int>(r % Lq);
  const float4* src =
      reinterpret_cast<const float4*>(ws + (static_cast<long>(bh) * Lqp + row) * D + c);
  const float4 a = src[0], e = src[1];
  uint4 out;
  out.x = pack_bf16(a.x * scale, a.y * scale);
  out.y = pack_bf16(a.z * scale, a.w * scale);
  out.z = pack_bf16(e.x * scale, e.y * scale);
  out.w = pack_bf16(e.z * scale, e.w * scale);
  const int b = bh / H, h = bh % H;
  *reinterpret_cast<uint4*>(dq + b * sb + h * sh + row * sl + c) = out;
}

// ---------------------------------------------------------------------------
// dkvq, bf16: TMA + mbarrier rings, wgmma
// ---------------------------------------------------------------------------
constexpr int KB = 128;               // keys per block: two consumer warpgroups of 64
constexpr int QB = 64;                // queries per streamed tile
constexpr int STAGES = 2;             // depth of each warpgroup's query-tile ring
constexpr int DKVQ_THREADS = 256;     // two warpgroups, no producer warp: 255 registers a thread
constexpr int TILE = 64 * BHD * 2;    // one 64 x 64 bf16 tile, 8 KB
constexpr int DQ_BUF = QB * BHD * 4;  // one 64 x 64 f32 dq tile, 16 KB
// shared memory: per warpgroup w (its 64 keys, its own ring and buffers)
constexpr int OFF_K = 0;                                  // + w TILE
constexpr int OFF_V = 2 * TILE;                           // + w TILE
constexpr int OFF_RING = 4 * TILE;                        // + (w STAGES + s) 2 TILE: q, do
constexpr int OFF_DS = OFF_RING + 2 * STAGES * 2 * TILE;  // + w 2 TILE: ds hi, ds lo
constexpr int OFF_DQ = OFF_DS + 4 * TILE;                 // + (2 w + i) DQ_BUF
constexpr int OFF_ROWS = OFF_DQ + 4 * DQ_BUF;             // + (w STAGES + s) 512: lse, delta
constexpr int OFF_BAR = OFF_ROWS + 2 * STAGES * 2 * QB * 4;
constexpr int N_BARS = 2 * (STAGES + 1);                  // per warpgroup: full[s], kv
constexpr int DKVQ_SMEM = ((OFF_BAR + N_BARS * 8 + 15) / 16) * 16 + 1024;  // + alignment

struct DkvqParams {
  const float* lse2;   // (B*H, Lqp), units of log 2
  const float* delta;  // (B*H, Lqp)
  const float* kbias;  // (B, Lk) or nullptr
  const float* fbias;  // (Lq, Lk) or nullptr
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl;
  int H, Lq, Lk, Lqp;
  float scale;
};

// Each warpgroup w owns 64 keys and runs alone: it loads its own K, V and
// query tiles (its thread 0 issues the copies), and sends its own dQ part.
// Accumulator element i of a thread: row 16 warp + g + 8 ((i >> 1) & 1),
// column 8 (i >> 2) + 2 t + (i & 1) (the wgmma m64nN f32 layout).
template <bool FULL_BIAS>
__global__ void __launch_bounds__(DKVQ_THREADS, 1)
    flash_bwd_dkvq_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq, const DkvqParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int nq = (p.Lq + QB - 1) / QB;
  const int tid = threadIdx.x;
  // the warpgroup index through a shuffle: the compiler then knows it is
  // warp-uniform, and the wgmma descriptors built from it stay uniform
  const int w = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int lt = tid & 127, wi = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t bar_full = base + OFF_BAR + w * (STAGES + 1) * 8, bar_kv = bar_full + STAGES * 8;

  if (tid == 0) {
    for (int i = 0; i < N_BARS; ++i) mbar_init(base + OFF_BAR + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const uint32_t k_tile = base + OFF_K + w * TILE, v_tile = base + OFF_V + w * TILE;
  const float* lse_row = p.lse2 + static_cast<long>(bh) * p.Lqp;
  const float* del_row = p.delta + static_cast<long>(bh) * p.Lqp;
  // query tile qt into stage qt % STAGES (issued by thread 0 of the warpgroup)
  auto load_tile = [&](int qt) {
    const int s = qt % STAGES;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t q_dst = base + OFF_RING + (w * STAGES + s) * 2 * TILE;
    const uint32_t rows_dst = base + OFF_ROWS + (w * STAGES + s) * 2 * QB * 4;
    mbar_expect_tx(full, 2 * TILE + 2 * QB * 4);
    tma_load_4d(q_dst, &tm_q, full, 0, qt * QB, h, b);
    tma_load_4d(q_dst + TILE, &tm_do, full, 0, qt * QB, h, b);
    bulk_load(rows_dst, lse_row + qt * QB, QB * 4, full);
    bulk_load(rows_dst + QB * 4, del_row + qt * QB, QB * 4, full);
  };
  if (lt == 0) {
    mbar_expect_tx(bar_kv, 2 * TILE);
    tma_load_4d(k_tile, &tm_k, bar_kv, 0, kt * KB + w * 64, h, b);
    tma_load_4d(v_tile, &tm_v, bar_kv, 0, kt * KB + w * 64, h, b);
    for (int qt = 0; qt < STAGES && qt < nq; ++qt) load_tile(qt);
  }

  const int r0 = wi * 16 + g;  // this thread's rows of every accumulator: r0, r0 + 8
  const int key0 = kt * KB + w * 64 + r0, key1 = key0 + 8;
  const bool kl0 = key0 < p.Lk, kl1 = key1 < p.Lk;
  // per-key additive terms in units of log 2; a key past Lk is masked
  float kb0 = kl0 ? 0.0f : -INFINITY, kb1 = kl1 ? 0.0f : -INFINITY;
  if (p.kbias != nullptr) {
    const float* kb = p.kbias + static_cast<long>(b) * p.Lk;
    if (kl0) kb0 = kb[key0] * kBwdLog2e;
    if (kl1) kb1 = kb[key1] * kBwdLog2e;
  }
  const float scale2 = p.scale * kBwdLog2e;
  const uint32_t ds_hi = base + OFF_DS + w * 2 * TILE, ds_lo = ds_hi + TILE;
  // a k-step of 16 advances a K-major tile by 32 bytes (2 in the address
  // field), an MN-major tile by 16 rows of 128 bytes (128)
  const uint64_t kt_desc = desc_sw128(k_tile, true);
  const uint64_t dsh_desc = desc_sw128(ds_hi, true), dsl_desc = desc_sw128(ds_lo, true);

  // K and V of this warpgroup's 64 keys as wgmma A fragments (ldmatrix from
  // the swizzled tiles): S^T = K Q^T and dP^T = V dO^T read only Q / dO
  // from shared memory
  unsigned ka[4][4], va[4][4];
  mbar_wait(bar_kv, 0);
  {
    const int r = wi * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = r * 128 + (((2 * kk + (lane >> 4)) ^ (r & 7)) << 4);
      ldmatrix_x4(ka[kk], k_tile + off);
      ldmatrix_x4(va[kk], v_tile + off);
    }
  }

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }
  for (int qt = 0; qt < nq; ++qt) {
    const int s = qt % STAGES;
    mbar_wait(bar_full + 8 * s, (qt / STAGES) & 1);
    const uint32_t q_tile = base + OFF_RING + (w * STAGES + s) * 2 * TILE, do_tile = q_tile + TILE;
    const uint64_t q_desc = desc_sw128(q_tile, false), do_desc = desc_sw128(do_tile, false);
    const uint64_t qt_desc = desc_sw128(q_tile, true), dot_desc = desc_sw128(do_tile, true);
    // lse and delta of the tile's rows; this thread's columns come in pairs
    // 8 jn + 2 t, + 1
    const uint32_t lse_u = base + OFF_ROWS + (w * STAGES + s) * 2 * QB * 4, del_u = lse_u + QB * 4;

    // S^T = K Q^T and dP^T = V dO^T: A from registers, B K-major (k = d)
    float st[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(st, ka[kk], q_desc + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(dp, va[kk], do_desc + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // p^T = 2^(s scale2 + bias2 - lse2); rows keys, columns queries
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 l2 = lds_f2(lse_u + (8 * jn + 2 * t) * 4);  // lse in units of log 2
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jn + e, c = 8 * jn + 2 * t + (e & 1);
        const bool hi_row = e >> 1;
        float x = fmaf(st[i], scale2, hi_row ? kb1 : kb0);
        if (FULL_BIAS) {
          const int qrow = qt * QB + c, key = hi_row ? key1 : key0;
          if (qrow < p.Lq && key < p.Lk)
            x += p.fbias[static_cast<long>(qrow) * p.Lk + key] * kBwdLog2e;
        }
        st[i] = ex2(x - ((e & 1) ? l2.y : l2.x));
      }
    }
    // dV += P^T dO: P^T's accumulator fragments are A fragments (k =
    // queries); B = dO, MN-major
    unsigned pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dv, pa[kk], dot_desc + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dp);

    // dS^T / scale = P^T (dP^T - delta), as hi + lo bf16 (the scale, a
    // power of 2, goes on dk at the end and on dq in the cast kernel), into
    // the dS^T tiles (rows keys, 64 queries of 128 bytes, 128B swizzle); hi
    // stays in registers as dK's A fragments
    // delta first, all at once: the loads would otherwise wait for the
    // stores before them (both are volatile)
    float2 dl[8];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) dl[jn] = lds_f2(del_u + (8 * jn + 2 * t) * 4);
    unsigned hi[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e, jn = 2 * kk + (e >> 1);
        const float a = st[i] * (dp[i] - dl[jn].x), c = st[i + 1] * (dp[i + 1] - dl[jn].y);
        const __nv_bfloat162 hv = __floats2bfloat162_rn(a, c);
        hi[kk][e] = *reinterpret_cast<const unsigned*>(&hv);
        const uint32_t off = (r0 + 8 * (e & 1)) * 128 + (((2 * kk + (e >> 1)) ^ g) << 4) + 4 * t;
        sts_u32(ds_hi + off, hi[kk][e]);
        sts_u32(ds_lo + off, pack_bf16(a - __low2float(hv), c - __high2float(hv)));
      }
    // dK += dS^T Q (hi alone), B = Q, MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dk, hi[kk], qt_desc + 128 * kk, 1);
    wgmma_commit();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    // the dq buffer of this tile was sent two tiles ago: that reduce has
    // read it once at most one bulk group is pending
    if (lt == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    named_sync(1 + w, 128);  // every thread's dS^T is in shared memory
    // this warpgroup's part of dQ = dS K over its 64 keys: A = dS (the dS^T
    // tile, MN-major), B = K (MN-major), k = keys; hi then lo
    float dq[32];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(dq, dsh_desc + 128 * kk, kt_desc + 128 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<1, 1>(dq, dsl_desc + 128 * kk, kt_desc + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(hi);

    // dQ part -> two 64 x 32 f32 boxes, 128B-swizzled as the workspace's
    // TMA map reads them, then one reduce-add each into the workspace
    const uint32_t buf = base + OFF_DQ + (2 * w + (qt & 1)) * DQ_BUF;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 8 * ((i >> 1) & 1), jn = i >> 2;  // n8 block of d
      const int chunk = 2 * (jn & 3) + (t >> 1);            // 16-byte chunk in the 128-byte row
      const uint32_t off = (jn >> 2) * (DQ_BUF / 2) + row * 128 + ((chunk ^ g) << 4) + (t & 1) * 8;
      sts_f2(buf + off, dq[i], dq[i + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + w, 128);  // the buffer is written; the stage is read
    if (lt == 0) {
      const int row = bh * p.Lqp + qt * QB;
      tma_reduce_add_2d(&tm_dq, buf, 0, row);
      tma_reduce_add_2d(&tm_dq, buf + DQ_BUF / 2, 32, row);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (qt + STAGES < nq) load_tile(qt + STAGES);  // refill the stage just read
    }
  }
  if (lt == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

  __nv_bfloat16* DK = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* DV = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const bool hi_row = (i >> 1) & 1;
    const int key = hi_row ? key1 : key0, col = 8 * (i >> 2) + 2 * t;
    if (key < p.Lk) {
      *reinterpret_cast<__nv_bfloat162*>(DK + static_cast<long>(key) * p.dk_sl + col) =
          __floats2bfloat162_rn(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(DV + static_cast<long>(key) * p.dv_sl + col) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: one register-tiled SIMT pass
// ---------------------------------------------------------------------------
constexpr int FKB = 64;         // keys per block
constexpr int FQB = 64;         // queries per streamed tile
constexpr int F_THREADS = 128;  // two groups of 64: S, P, dV and dP, dS, dK
constexpr int F_TILE = 64 * BHD * 4;  // a 64 x 64 f32 tile: two 64-row x 128-byte boxes
constexpr int F_OFF_K = 0;
constexpr int F_OFF_V = F_TILE;
constexpr int F_OFF_Q = 2 * F_TILE;
constexpr int F_OFF_DO = 3 * F_TILE;
constexpr int F_OFF_P = 4 * F_TILE;   // P, then the tile's dq part for the reduce-add
constexpr int F_OFF_DS = 5 * F_TILE;
constexpr int F_OFF_ROWS = 6 * F_TILE;                // the tile's lse, then delta rows
constexpr int F_OFF_BAR = F_OFF_ROWS + 2 * FQB * 4;   // tile full, K and V
constexpr int F32_SMEM = F_OFF_BAR + 2 * 8 + 1024;    // + alignment: 2 blocks an SM

// s[m][n] = sum_d K[kr + 8 m][d] Q[tj + 8 n][d] and dp[m][n] = sum_d
// V[kr + 8 m][d] dO[tj + 8 n][d] over the tiles' 64 columns (m < 4, n < 8):
// four rows of K and V and eight of Q and dO by 16-byte chunks, each K or
// V value loaded feeding eight FFMAs, each Q or dO value four
__device__ __forceinline__ void f32_score_products(float (&s)[4][8], float (&dp)[4][8],
                                                   uint32_t k, uint32_t v, uint32_t q,
                                                   uint32_t d_o, int kr, int tj) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[m][n] = 0.0f;
      dp[m][n] = 0.0f;
    }
#pragma unroll 2
  for (int c = 0; c < 16; ++c) {
    const uint32_t ko = ((c >> 3) << 13) + (kr << 7) + (((c ^ kr) & 7) << 4);
    const uint32_t qo = ((c >> 3) << 13) + (tj << 7) + (((c ^ tj) & 7) << 4);
    float4 ka[4], va[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      ka[m] = lds_f4(k + ko + (m << 10));
      va[m] = lds_f4(v + ko + (m << 10));
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float4 qb = lds_f4(q + qo + (n << 10)), ob = lds_f4(d_o + qo + (n << 10));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        s[m][n] = fmaf(ka[m].x, qb.x, s[m][n]);
        s[m][n] = fmaf(ka[m].y, qb.y, s[m][n]);
        s[m][n] = fmaf(ka[m].z, qb.z, s[m][n]);
        s[m][n] = fmaf(ka[m].w, qb.w, s[m][n]);
        dp[m][n] = fmaf(va[m].x, ob.x, dp[m][n]);
        dp[m][n] = fmaf(va[m].y, ob.y, dp[m][n]);
        dp[m][n] = fmaf(va[m].z, ob.z, dp[m][n]);
        dp[m][n] = fmaf(va[m].w, ob.w, dp[m][n]);
      }
    }
  }
}

// acc[i][j] += sum_r A[r][4 ti + 32 (i >> 2) + (i & 3)] B[r][4 tj + 32 (j >>
// 2) + (j & 3)] over the tiles' 64 rows r (queries): NA chunks of a row of A
// and NB of B, each value loaded feeding 4 NB or 4 NA FFMAs (dV += P^T dO,
// dK += dS^T Q; <2, 2> at head dim 64, <1, 3> at 96)
template <int NA, int NB>
__device__ __forceinline__ void f32_cols_product(float (&acc)[4 * NA][4 * NB], uint32_t a,
                                                 uint32_t b, int ti, int tj) {
#pragma unroll 8
  for (int r = 0; r < FQB; ++r) {
    float av[4 * NA], bv[4 * NB];
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const float4 v = lds_f4(f32_chunk(a, r, ti + 8 * x));
      av[4 * x] = v.x;
      av[4 * x + 1] = v.y;
      av[4 * x + 2] = v.z;
      av[4 * x + 3] = v.w;
    }
#pragma unroll
    for (int y = 0; y < NB; ++y) {
      const float4 v = lds_f4(f32_chunk(b, r, tj + 8 * y));
      bv[4 * y] = v.x;
      bv[4 * y + 1] = v.y;
      bv[4 * y + 2] = v.z;
      bv[4 * y + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * NA; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dq[i][j] += sum_key dS[tq + 16 i][key] K[key][4 td + 32 (j >> 2) + (j & 3)]
// over the tile's keys 4 c0 .. 4 (c0 + NCK) - 1 (all 64 by the one-pass
// kernel's 128 threads: <2, 16>)
template <int NB, int NCK>
__device__ __forceinline__ void f32_dq_product(float (&dq)[4][4 * NB], uint32_t ds, uint32_t k,
                                               int tq, int td, int c0) {
#pragma unroll 2
  for (int c = c0; c < c0 + NCK; ++c) {  // keys 4c .. 4c + 3
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = lds_f4(f32_chunk(ds, tq + 16 * i, c));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float bv[4 * NB];
#pragma unroll
      for (int y = 0; y < NB; ++y) {
        const float4 v = lds_f4(f32_chunk(k, 4 * c + e, td + 8 * y));
        bv[4 * y] = v.x;
        bv[4 * y + 1] = v.y;
        bv[4 * y + 2] = v.z;
        bv[4 * y + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = e == 0 ? av[i].x : e == 1 ? av[i].y : e == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 4 * NB; ++j) dq[i][j] = fmaf(a, bv[j], dq[i][j]);
      }
    }
  }
}

// One block per (64-key tile, batch*head), 128 threads; K and V of its keys
// by TMA once, the query tiles of q and do (and their lse and delta rows)
// streamed through one buffer. Per query tile, with ti = lane / 8 + 4 (warp
// % 2), tj = lane % 8 in each group g of 64 threads:
//   both:    S^T = K Q^T and dP^T = V dO^T for keys 32 g + ti + 8m, queries
//            tj + 8n, then P^T = exp(S^T scale + bias - lse) and dS^T =
//            P^T (dP^T - delta) scale of the same elements in registers,
//            P and dS to shared memory (each group its 32 keys: no group
//            waits for the other's elements);
//   group 0: dV += P^T dO; group 1: dK += dS^T Q (keys 4 ti + 32 h + e, d
//            4 tj + 32 h' + e'), 8 x 8 accumulators held over all tiles;
//   all:     dq part = dS K (queries tq + 16 i, d 4 td + 32 h' + e'),
//            staged in P's buffer and added into dq by TMA reduce-add while
//            the next tile's products run.
// Keys past Lk are masked (-inf); query rows past Lq load as zeros with lse
// 1e30 (p = 0), and their dq rows fall outside the reduce-add's map.
template <bool FULL_BIAS>
__global__ void __launch_bounds__(F_THREADS, 2)
    flash_bwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dq, const FlashBwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int nq = (p.Lq + FQB - 1) / FQB;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const int grp = warp >> 1;
  const int ti = (lane >> 3) + 4 * (warp & 1), tj = lane & 7;
  const int tq = tid >> 3, td = tid & 7;
  const uint32_t k_s = base + F_OFF_K, v_s = base + F_OFF_V, q_s = base + F_OFF_Q,
                 do_s = base + F_OFF_DO, p_s = base + F_OFF_P, ds_s = base + F_OFF_DS,
                 rows_s = base + F_OFF_ROWS;
  const uint32_t bar_full = base + F_OFF_BAR, bar_kv = bar_full + 8;
  const float* lse_row = p.lse + static_cast<long>(bh) * p.Lqp;
  const float* del_row = p.delta + static_cast<long>(bh) * p.Lqp;
  // query tile qt's q, do, lse and delta (issued by thread 0)
  auto load_tile = [&](int qt) {
    mbar_expect_tx(bar_full, 2 * F_TILE + 2 * FQB * 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      tma_load_4d(q_s + half * (F_TILE / 2), &tm_q, bar_full, 32 * half, qt * FQB, h, b);
      tma_load_4d(do_s + half * (F_TILE / 2), &tm_do, bar_full, 32 * half, qt * FQB, h, b);
    }
    bulk_load(rows_s, lse_row + qt * FQB, FQB * 4, bar_full);
    bulk_load(rows_s + FQB * 4, del_row + qt * FQB, FQB * 4, bar_full);
  };
  if (tid == 0) {
    mbar_init(bar_full, 1);
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * F_TILE);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      tma_load_4d(k_s + half * (F_TILE / 2), &tm_k, bar_kv, 32 * half, kt * FKB, h, b);
      tma_load_4d(v_s + half * (F_TILE / 2), &tm_v, bar_kv, 32 * half, kt * FKB, h, b);
    }
    load_tile(0);
  }

  // the additive term of this thread's S^T keys kt * 64 + kr + 8m; a key
  // past Lk is masked
  const int kr = 32 * grp + ti;
  float kb[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int key = kt * FKB + kr + 8 * m;
    kb[m] = key < p.Lk ? (p.kbias != nullptr ? p.kbias[static_cast<long>(b) * p.Lk + key] : 0.0f)
                       : -INFINITY;
  }
  float acc[8][8];  // dV (group 0) or dK (group 1)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // group 0: dV += P^T dO; group 1: dK += dS^T Q
  const uint32_t ca = grp ? ds_s : p_s, cb = grp ? q_s : do_s;
  mbar_wait(bar_kv, 0);

  for (int qt = 0; qt < nq; ++qt) {
    mbar_wait(bar_full, qt & 1);
    float s[4][8], dp[4][8];
    f32_score_products(s, dp, k_s, v_s, q_s, do_s, kr, tj);
    float lse[8], dl[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      lse[n] = __uint_as_float(lds_u32(rows_s + 4 * (tj + 8 * n)));
      dl[n] = __uint_as_float(lds_u32(rows_s + FQB * 4 + 4 * (tj + 8 * n)));
    }
    // P's buffer held the last tile's dq part: the reduce-add has read it
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float x = fmaf(s[m][n], p.scale, kb[m]);
        if (FULL_BIAS) {
          const int qrow = qt * FQB + tj + 8 * n, key = kt * FKB + kr + 8 * m;
          if (qrow < p.Lq && key < p.Lk) x += p.fbias[static_cast<long>(qrow) * p.Lk + key];
        }
        const float pv = expf(x - lse[n]);
        sts_f32(f32_at(p_s, tj + 8 * n, kr + 8 * m), pv);
        sts_f32(f32_at(ds_s, tj + 8 * n, kr + 8 * m), pv * (dp[m][n] - dl[n]) * p.scale);
      }
    __syncthreads();  // P and dS are written
    f32_cols_product<2, 2>(acc, ca, cb, ti, tj);
    __syncthreads();  // q, do, lse, delta and P are read
    if (tid == 0 && qt + 1 < nq) load_tile(qt + 1);

    float dq[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dq[i][j] = 0.0f;
    f32_dq_product<2, 16>(dq, ds_s, k_s, tq, td, 0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        sts_f4(f32_chunk(p_s, tq + 16 * i, td + 8 * hh),
               make_float4(dq[i][4 * hh], dq[i][4 * hh + 1], dq[i][4 * hh + 2], dq[i][4 * hh + 3]));
    fence_proxy_async();  // the dq part, seen by TMA
    __syncthreads();      // the dq part is staged; dS is read
    if (tid == 0) {
      tma_reduce_add_4d(&tm_dq, p_s, 0, qt * FQB, h, b);
      tma_reduce_add_4d(&tm_dq, p_s + F_TILE / 2, 32, qt * FQB, h, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");

  // dV (group 0) or dK (group 1): keys kt * 64 + 4 ti + 32 (i >> 2) + (i & 3)
  float* out = grp ? static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh
                   : static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const long sl = grp ? p.dk_sl : p.dv_sl;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = kt * FKB + 4 * ti + 32 * (i >> 2) + (i & 3);
    if (key < p.Lk)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float4*>(out + key * sl + 4 * tj + 32 * hh) =
            make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2],
                        acc[i][4 * hh + 3]);
  }
}

// ---------------------------------------------------------------------------
// head dim 96: the dQ sums in a fixed order. One block per (key tile, b*h),
// handed out by a ticket; the dQ part of each (query tile, b*h) is added
// into the f32 sum by one TMA reduce-add a block (key tile 0's is stored),
// in ascending key-tile order: a block waits for the tile's turn counter to
// read its key tile, adds, waits for the add to complete and passes the
// turn on.
// ---------------------------------------------------------------------------

// the block's work item from the ticket counter (counters[0], zeroed by the
// launch's entry point), which hands tickets out in the order blocks start:
// every block a block waits on (a lower key tile of its b*h) has a lower
// ticket, so it has started, and the waits cannot deadlock however many
// blocks are resident. Key tiles run fastest, so the blocks in flight share
// few heads.
__device__ __forceinline__ int take_ticket(int* counters, uint32_t slot) {
  if (threadIdx.x == 0) sts_u32(slot, static_cast<unsigned>(atomicAdd(counters, 1)));
  __syncthreads();
  return static_cast<int>(lds_u32(slot));
}

// waits (one thread) until the turn counter reads `mine`; traps (a launch
// error, not a hung card) if it never does
__device__ __forceinline__ void wait_turn(const int* turn, int mine) {
  uint32_t polls = 0;
  while (ld_acquire_gpu(turn) != mine) {
    if (++polls == (1u << 24)) __trap();
    __nanosleep(64);
  }
  fence_proxy_async_global();  // the earlier blocks' adds, before this block's
}

// after this thread's reduce-adds were committed: waits for them to
// complete, then passes the turn `mine` on to the next key tile
__device__ __forceinline__ void pass_turn(int* turn, int mine) {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  fence_proxy_async_global();
  st_release_gpu(turn, mine + 1);
}

namespace bwd96 {
constexpr int HD = 96;
constexpr int BK = 128;           // keys of a block: two warpgroups of 64
constexpr int BQ = 64;            // queries of a streamed tile
// two warpgroups and no producer warp: up to 255 registers a thread (ptxas
// left a producer warpgroup's consumers 192 under setmaxnreg, and 168 a
// thread at 288 threads: they spilled)
constexpr int THREADS = 256;
constexpr int STAGES = 3;         // depth of the query-tile ring
constexpr int PANEL = 64 * 64;    // 64 rows x 32 bf16 columns, 64-byte rows, 64B swizzle
constexpr int TILE = 3 * PANEL;   // a 64 x 96 bf16 tile, 12 KB
constexpr int DS_TILE = 64 * 128; // dS^T of a warpgroup: 64 keys x 64 queries bf16, 128B swizzle
constexpr int DQ_BOX = BQ * 128;  // 64 query rows x 32 f32 columns, 128B swizzle
constexpr int DQ_BUF = 3 * DQ_BOX;  // a tile's dQ part, 64 x 96 f32, 24 KB
// shared memory
constexpr int OFF_K = 0;                              // + c TILE (warpgroup c's 64 keys)
constexpr int OFF_V = 2 * TILE;                       // + c TILE
constexpr int OFF_RING = 4 * TILE;                    // + s 2 TILE: q, do
constexpr int OFF_DS = OFF_RING + STAGES * 2 * TILE;  // + c 2 DS_TILE: hi, lo
constexpr int OFF_DQ = OFF_DS + 4 * DS_TILE;          // + j DQ_BUF (j: tile parity)
constexpr int OFF_ROWS = OFF_DQ + 2 * DQ_BUF;         // + s 2 BQ floats: lse, delta
constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
// full[s], empty[s], kv, part[j], dq_full[j]; then the ticket
constexpr int N_BARS = 2 * STAGES + 5;
constexpr int OFF_TICKET = OFF_BAR + N_BARS * 8;
constexpr int SMEM = ((OFF_TICKET + 4 + 15) / 16) * 16 + 1024;  // + alignment
static_assert(SMEM <= 232448, "over the 227 KB a block can use");
static_assert(OFF_DS % 1024 == 0 && OFF_DQ % 1024 == 0, "128B-swizzled tiles at 1024 bytes");

// a 64-row tile of a (B, H, L, 96) map at row `row` of (b, h): three boxes
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row,
                                          int h, int b) {
#pragma unroll
  for (int c = 0; c < HD / 32; ++c) tma_load_4d(dst + c * PANEL, m, bar, 32 * c, row, h, b);
}
// k-step kk (16 columns) of a K-major tile of three panels: panel kk / 2,
// 32 bytes on for odd kk, as a step of a descriptor's address field
__device__ __forceinline__ uint64_t kstep(int kk) {
  return static_cast<uint64_t>((kk >> 1) * (PANEL >> 4) + 2 * (kk & 1));
}
}  // namespace bwd96

struct Dkvq96Params {
  const float* lse2;   // (B*H, Lqp), units of log 2
  const float* delta;  // (B*H, Lqp)
  const float* kbias;  // (B, Lk) or nullptr
  const float* fbias;  // (Lq, Lk) or nullptr
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int* counters;       // [0] the ticket, then the turn of each (b*h, query tile), zeroed
  long dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl;
  int H, Lq, Lk, Lqp, key_tiles;
  float scale;
};

// dK, dV and the dQ sums at head dim 96, bf16, in one pass. One block per
// (key tile of 128, batch*head), from the ticket; warpgroups c = 0, 1, each
// with 64 keys, their K and V tiles loaded once. Per query tile a warpgroup
// computes S^T = K Q^T and dP^T = V dO^T (m64n64k16 from shared memory), P^T
// and dS^T in registers, dV += P^T dO and dK += dS^T Q (m64n96k16, A from
// registers; 48 + 48 accumulators a thread, held over the pass), stores its
// dS^T as hi and lo bf16 tiles, and its part of dQ = dS K over its 64 keys
// (m64n96k16 from shared memory: A = dS^T MN-major, B = K MN-major), hi then
// lo. Warpgroup 0 stores its part in the tile's buffer (two, alternating,
// 128B-swizzled as the workspace's map reads them) and warpgroup 1 adds its
// own to it (the two parts in a fixed order). Warpgroup 0 leads: at the end
// of tile qt its thread 0 adds tile qt - 1's sum into the f32 workspace in
// its turn, and passes the turn on in the middle of tile qt + 1, once the
// adds have completed without waiting for them. Nothing else couples the
// warpgroups, so one's element work runs beside the other's products.
// Thread 160 loads by TMA: K and V once, then each query tile (q, do, their
// lse and delta rows) through a three-stage ring, each stage refilled once
// both warpgroups have read it.
// The values are the one-pass hd-64 kernel's: p = 2^(s scale2 + bias2 -
// lse2), dV takes bf16(p), dK takes bf16(p (dp - delta)), dQ hi + lo; the
// scale on dk at the end and on dq in the cast kernel. Accumulator element i
// of a thread: row 16 warp + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t +
// (i & 1).
template <bool FULL_BIAS>
__global__ void __launch_bounds__(bwd96::THREADS, 1)
    flash_bwd_dkvq96_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_dq, const Dkvq96Params p) {
  // block-scope names: they hide the hd-64 dkvq kernel's TILE, STAGES and offsets
  using bwd96::BK, bwd96::BQ, bwd96::HD, bwd96::PANEL, bwd96::STAGES, bwd96::TILE,
      bwd96::DS_TILE, bwd96::DQ_BOX, bwd96::DQ_BUF, bwd96::kstep, bwd96::load_tile;
  using bwd96::OFF_BAR, bwd96::OFF_DQ, bwd96::OFF_DS, bwd96::OFF_K, bwd96::OFF_RING,
      bwd96::OFF_ROWS, bwd96::OFF_TICKET, bwd96::OFF_V;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int c = __shfl_sync(0xffffffffu, tid >> 7, 0);  // the warpgroup, warp-uniform
  const uint32_t full = base + OFF_BAR, empty = full + STAGES * 8, bar_kv = empty + STAGES * 8;
  const uint32_t part = bar_kv + 8, dq_full = part + 16;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);  // every thread
    }
    mbar_init(bar_kv, 1);
    for (int j = 0; j < 2; ++j) {
      mbar_init(part + 8 * j, 128);     // warpgroup 0's part is in the buffer
      mbar_init(dq_full + 8 * j, 128);  // warpgroup 1 has added its own
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int item = take_ticket(p.counters, base + OFF_TICKET);  // syncs
  const int kt = item % p.key_tiles, bh = item / p.key_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int nq = (p.Lq + BQ - 1) / BQ;
  int* turns = p.counters + 1 + static_cast<long>(bh) * nq;
  const float* lse_row = p.lse2 + static_cast<long>(bh) * p.Lqp;
  const float* del_row = p.delta + static_cast<long>(bh) * p.Lqp;
  // query tile qt (q, do, lse and delta rows) into stage qt % STAGES
  auto load_q_tile = [&](int qt) {
    const int s = qt % STAGES;
    const uint32_t bar = full + 8 * s, dst = base + OFF_RING + s * 2 * TILE;
    const uint32_t rows = base + OFF_ROWS + s * 2 * BQ * 4;
    mbar_expect_tx(bar, 2 * TILE + 2 * BQ * 4);
    load_tile(dst, &tm_q, bar, qt * BQ, h, b);
    load_tile(dst + TILE, &tm_do, bar, qt * BQ, h, b);
    bulk_load(rows, lse_row + qt * BQ, BQ * 4, bar);
    bulk_load(rows + BQ * 4, del_row + qt * BQ, BQ * 4, bar);
  };
  // tile m's summed dQ part into the workspace in its turn (thread 0; the
  // turn is passed on once the adds complete, by pass_turn). Key tile 0's
  // part is stored, the others added, so the workspace needs no zeroing
  auto add_in_turn = [&](int m) {
    const uint32_t src = base + OFF_DQ + (m & 1) * DQ_BUF;
    mbar_wait(dq_full + 8 * (m & 1), (m >> 1) & 1);
    wait_turn(turns + m, kt);
    const int row = bh * p.Lqp + m * BQ;
    if (kt == 0) {
#pragma unroll
      for (int x = 0; x < 3; ++x) tma_store_2d(&tm_dq, src + x * DQ_BOX, 32 * x, row);
    } else {
#pragma unroll
      for (int x = 0; x < 3; ++x) tma_reduce_add_2d(&tm_dq, src + x * DQ_BOX, 32 * x, row);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  };
  if (tid == 160) {
    mbar_expect_tx(bar_kv, 4 * TILE);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      load_tile(base + OFF_K + w * TILE, &tm_k, bar_kv, kt * BK + 64 * w, h, b);
      load_tile(base + OFF_V + w * TILE, &tm_v, bar_kv, kt * BK + 64 * w, h, b);
    }
    for (int qt = 0; qt < STAGES && qt < nq; ++qt) load_q_tile(qt);
  }

  const int lt = tid & 127, wi = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wi * 16 + g;  // this thread's rows (keys) of every accumulator: r0, r0 + 8
  const int key0 = kt * BK + 64 * c + r0, key1 = key0 + 8;
  const bool kl0 = key0 < p.Lk, kl1 = key1 < p.Lk;
  // per-key additive terms in units of log 2; a key past Lk is masked
  float kb0 = kl0 ? 0.0f : -INFINITY, kb1 = kl1 ? 0.0f : -INFINITY;
  if (p.kbias != nullptr) {
    const float* kb = p.kbias + static_cast<long>(b) * p.Lk;
    if (kl0) kb0 = kb[key0] * kBwdLog2e;
    if (kl1) kb1 = kb[key1] * kBwdLog2e;
  }
  const float scale2 = p.scale * kBwdLog2e;
  const uint32_t k_tile = base + OFF_K + c * TILE;
  const uint32_t ds_hi = base + OFF_DS + c * 2 * DS_TILE, ds_lo = ds_hi + DS_TILE;
  // descriptors as a base and an immediate step each (a tile's address
  // field never carries past its 14 bits): S^T's A = K and dP^T's A = V,
  // K-major; dQ's A = dS^T, MN-major (a k-step of 16 keys: 16 rows of 128
  // bytes), and B = K, MN-major over its three panels (16 rows of 64 bytes)
  const uint64_t ka_desc = desc_sw64(k_tile), va_desc = desc_sw64(base + OFF_V + c * TILE);
  const uint64_t kq_desc = desc_sw64_mn(k_tile, PANEL);
  const uint64_t dsh_desc = desc_sw128(ds_hi, true), dsl_desc = desc_sw128(ds_lo, true);

  float dk[48], dv[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }
  int passed = 0;  // thread 0: the first tile whose turn it has not passed on
  mbar_wait(bar_kv, 0);
  for (int qt = 0; qt < nq; ++qt) {
    const int s = qt % STAGES, j = qt & 1;
    mbar_wait(full + 8 * s, (qt / STAGES) & 1);
    const uint32_t q_tile = base + OFF_RING + s * 2 * TILE, do_tile = q_tile + TILE;
    const uint32_t lse_u = base + OFF_ROWS + s * 2 * BQ * 4, del_u = lse_u + BQ * 4;
    const uint64_t q_desc = desc_sw64(q_tile), do_desc = desc_sw64(do_tile);

    // S^T = K Q^T and dP^T = V dO^T, both K-major (k = d)
    float st[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0>(st, ka_desc + kstep(kk), q_desc + kstep(kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<0, 0>(dp, va_desc + kstep(kk), do_desc + kstep(kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // p^T = 2^(s scale2 + bias2 - lse2); rows keys, columns queries
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 l2 = lds_f2(lse_u + (8 * jn + 2 * t) * 4);  // lse in units of log 2
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jn + e, col = 8 * jn + 2 * t + (e & 1);
        const bool hi_row = e >> 1;
        float x = fmaf(st[i], scale2, hi_row ? kb1 : kb0);
        if (FULL_BIAS) {
          const int qrow = qt * BQ + col, key = hi_row ? key1 : key0;
          if (qrow < p.Lq && key < p.Lk)
            x += p.fbias[static_cast<long>(qrow) * p.Lk + key] * kBwdLog2e;
        }
        st[i] = ex2(x - ((e & 1) ? l2.y : l2.x));
      }
    }
    // thread 0 passes on the turn of the adds it issued at the end of the
    // last tile (they have completed meanwhile); the warpgroup's barrier
    // below frees their buffer for this tile's part
    if (tid == 0 && qt >= 2) {
      pass_turn(turns + qt - 2, kt);
      passed = qt - 1;
    }
    // dV += P^T dO: A = P^T from registers (k = queries), B = dO MN-major
    // over its three panels; a k-step of 16 queries is 16 rows of 64 bytes
    unsigned pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n96<1>(dv, pa[kk], desc_sw64_mn(do_tile, PANEL) + 64 * kk, 1);
    wgmma_commit();
    // dP^T and dV: P^T's bf16 fragments die before dS^T is formed
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(dv);
    fence_regs(pa);

    // dS^T / scale = P^T (dP^T - delta) as hi + lo bf16 into this
    // warpgroup's dS^T tiles (rows keys, 64 queries of 128 bytes, 128B
    // swizzle); hi stays in registers as dK's A fragments; delta a k-step at
    // a time. Its own dQ product of the last tile has read them.
    unsigned hi[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 dl0 = lds_f2(del_u + (16 * kk + 2 * t) * 4);
      const float2 dl1 = lds_f2(del_u + (16 * kk + 8 + 2 * t) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const float2 dl = (e >> 1) ? dl1 : dl0;
        const float a = st[i] * (dp[i] - dl.x), x = st[i + 1] * (dp[i + 1] - dl.y);
        const __nv_bfloat162 hv = __floats2bfloat162_rn(a, x);
        hi[kk][e] = *reinterpret_cast<const unsigned*>(&hv);
        const uint32_t off = (r0 + 8 * (e & 1)) * 128 + (((2 * kk + (e >> 1)) ^ g) << 4) + 4 * t;
        sts_u32(ds_hi + off, hi[kk][e]);
        sts_u32(ds_lo + off, pack_bf16(a - __low2float(hv), x - __high2float(hv)));
      }
    }
    // dK += dS^T Q (hi alone), B = Q MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n96<1>(dk, hi[kk], desc_sw64_mn(q_tile, PANEL) + 64 * kk, 1);
    wgmma_commit();
    // (a wait of one thread here, between the dK and dQ products, makes
    // ptxas serialize every wgmma of the kernel: C7520)
    fence_proxy_async();      // the dS^T stores, seen by wgmma
    named_sync(1 + c, 128);   // the warpgroup's dS^T is in shared memory
    // this warpgroup's part of dQ = dS K over its 64 keys, hi then lo
    float dq[48];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n96<1, 1>(dq, dsh_desc + 128 * kk, kq_desc + 64 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss_n96<1, 1>(dq, dsl_desc + 128 * kk, kq_desc + 64 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dk);
    fence_regs(hi);
    mbar_arrive(empty + 8 * s);  // the stage is read: q, do by wgmma, lse and delta

    // the tile's buffer: 64 query rows x 96 f32 as three 64-row x 32-float
    // boxes, 128B-swizzled as the workspace's map reads them; element i at
    // row r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t
    const uint32_t buf = base + OFF_DQ + j * DQ_BUF;
    auto at = [&](int i) {
      const int col = 8 * (i >> 2) + 2 * t;
      return buf + (col >> 5) * DQ_BOX + (r0 + 8 * ((i >> 1) & 1)) * 128 +
             ((((col & 31) >> 2) ^ g) << 4) + (t & 1) * 8;
    };
    if (c == 0) {
      // warpgroup 0 leads: its thread 0 adds tile qt - 1's sum in its turn
      // (and passes the turn on in the next tile); then warpgroup 0's part
      // goes into the buffer (the adds that read it completed before this
      // tile's warpgroup barrier)
      if (tid == 0 && qt >= 1) add_in_turn(qt - 1);
#pragma unroll
      for (int i = 0; i < 48; i += 2) sts_f2(at(i), dq[i], dq[i + 1]);
      mbar_arrive(part + 8 * j);
    } else {
      // warpgroup 1 adds its part to warpgroup 0's: the sum of the block's
      // 128 keys, in a fixed order
      mbar_wait(part + 8 * j, (qt >> 1) & 1);
#pragma unroll
      for (int i = 0; i < 48; i += 2) {
        const float2 w0 = lds_f2(at(i));
        sts_f2(at(i), w0.x + dq[i], w0.y + dq[i + 1]);
      }
      fence_proxy_async();  // the sum, seen by TMA
      mbar_arrive(dq_full + 8 * j);
      if (tid == 160 && qt + STAGES < nq) {  // both warpgroups have read the stage: refill it
        mbar_wait(empty + 8 * s, (qt / STAGES) & 1);
        load_q_tile(qt + STAGES);
      }
    }
  }
  // thread 0 passes on the turns of the adds issued so far, then adds the
  // last tile's sum in its turn: no turn waits behind another tile's turn
  // (a block's last turns would chain behind the blocks before it)
  if (tid == 0) {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    fence_proxy_async_global();
    for (; passed < nq - 1; ++passed) st_release_gpu(turns + passed, kt + 1);
    add_in_turn(nq - 1);
    pass_turn(turns + nq - 1, kt);
  }

  __nv_bfloat16* DK = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* DV = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 48; i += 2) {
    const bool hi_row = (i >> 1) & 1;
    const int key = hi_row ? key1 : key0, col = 8 * (i >> 2) + 2 * t;
    if (key < p.Lk) {
      *reinterpret_cast<__nv_bfloat162*>(DK + static_cast<long>(key) * p.dk_sl + col) =
          __floats2bfloat162_rn(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(DV + static_cast<long>(key) * p.dv_sl + col) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// head dim 96, f32: one register-tiled SIMT pass, the dQ sums in a fixed order
// ---------------------------------------------------------------------------
namespace f32bwd96 {
constexpr int HD = 96;
constexpr int BK = 64;              // keys of a block
constexpr int BQ = 64;              // queries of a streamed tile
constexpr int THREADS = 256;        // eight warps, one block an SM
constexpr int STAGES = 2;           // depth of the query-tile ring
constexpr int TILE = 64 * HD * 4;   // a 64 x 96 f32 tile: three 64-row x 128-byte boxes
constexpr int STILE = 64 * 64 * 4;  // P or dS: 64 queries x 64 keys, two boxes
// K, V; per stage q, do; P, dS; the tile's dQ part; per stage the lse,
// delta rows; full[s], kv; the ticket
constexpr int OFF_RING = 2 * TILE;
constexpr int OFF_P = OFF_RING + STAGES * 2 * TILE;
constexpr int OFF_DS = OFF_P + STILE;
constexpr int OFF_DQ = OFF_DS + STILE;
constexpr int OFF_ROWS = OFF_DQ + TILE;
constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
constexpr int OFF_TICKET = OFF_BAR + (STAGES + 1) * 8;
constexpr int SMEM = ((OFF_TICKET + 4 + 15) / 16) * 16 + 1024;  // + alignment
static_assert(SMEM <= 232448, "over the 227 KB a block can use");

// a 64-row tile of a (B, H, L, 96) f32 map at row `row` of (b, h): three boxes
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row,
                                          int h, int b) {
#pragma unroll
  for (int c = 0; c < HD / 32; ++c) tma_load_4d(dst + (c << 13), m, bar, 32 * c, row, h, b);
}
}  // namespace f32bwd96

// s[m][n] = sum_d X[xr + 4 m][d] Y[yr + 8 n][d] and t[m][n] = sum_d X2[xr +
// 4 m][d] Y2[yr + 8 n][d] (m, n < 4) over the tiles' NC 16-byte chunks (64-row
// f32 tiles in f32_chunk's layout): each X value loaded feeds four FFMAs,
// each Y value four. A warp's X rows (xr: four, with distinct r & 7) and Y
// rows (yr: eight, distinct r & 7) make every load one wavefront.
template <int NC>
__device__ __forceinline__ void f32_pair_products(float (&s)[4][4], float (&t)[4][4], uint32_t x,
                                                  uint32_t x2, uint32_t y, uint32_t y2, int xr,
                                                  int yr) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      s[m][n] = 0.0f;
      t[m][n] = 0.0f;
    }
#pragma unroll 2
  for (int c = 0; c < NC; ++c) {
    float4 xa[4], xb[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      xa[m] = lds_f4(f32_chunk(x, xr + 4 * m, c));
      xb[m] = lds_f4(f32_chunk(x2, xr + 4 * m, c));
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 ya = lds_f4(f32_chunk(y, yr + 8 * n, c)),
                   yb = lds_f4(f32_chunk(y2, yr + 8 * n, c));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        s[m][n] = fmaf(xa[m].x, ya.x, s[m][n]);
        s[m][n] = fmaf(xa[m].y, ya.y, s[m][n]);
        s[m][n] = fmaf(xa[m].z, ya.z, s[m][n]);
        s[m][n] = fmaf(xa[m].w, ya.w, s[m][n]);
        t[m][n] = fmaf(xb[m].x, yb.x, t[m][n]);
        t[m][n] = fmaf(xb[m].y, yb.y, t[m][n]);
        t[m][n] = fmaf(xb[m].z, yb.z, t[m][n]);
        t[m][n] = fmaf(xb[m].w, yb.w, t[m][n]);
      }
    }
  }
}

// dq[i][j] += sum_key dS[tq + 16 i][key] K[key][2 td + 32 (j >> 1) + (j & 1)]
// over the tile's 64 keys (i < 4, j < 6: the 64 x 96 dQ part by 256 threads,
// tq < 16, td < 16): per 4 keys four 16-byte loads of dS and twelve 8-byte
// loads of K for 96 FFMAs; a warp's K loads cover one 128-byte row (one
// wavefront), its dS loads two rows with distinct r & 7
__device__ __forceinline__ void f32_dq96_product(float (&dq)[4][6], uint32_t ds, uint32_t k, int tq,
                                                 int td) {
#pragma unroll 2
  for (int c = 0; c < 16; ++c) {  // keys 4c .. 4c + 3
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = lds_f4(f32_chunk(ds, tq + 16 * i, c));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float bv[6];
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        const float2 v = lds_f2(f32_at(k, 4 * c + e, 2 * td + 32 * y));
        bv[2 * y] = v.x;
        bv[2 * y + 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = e == 0 ? av[i].x : e == 1 ? av[i].y : e == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < 6; ++j) dq[i][j] = fmaf(a, bv[j], dq[i][j]);
      }
    }
  }
}

// dK, dV and the dQ sums at head dim 96, f32, in one pass: one block of 256
// threads per (key tile of 64, batch*head), from the ticket; K and V once,
// the query tiles (q, do by TMA, their lse and delta rows by bulk copy)
// through a two-stage ring. Per query tile:
//   all:       S^T = K Q^T and dP^T = V dO^T, a thread keys kr + 4 m and
//              queries qr + 8 n (m, n < 4); P^T = exp(S^T scale + bias -
//              lse) and dS^T = P^T (dP^T - delta) scale of its elements to
//              shared memory as P and dS (rows queries);
//   warps 0-3: dV += P^T dO; warps 4-7: dK += dS^T Q (keys 4 tkc + i,
//              columns 4 tj + 32 h + e: 4 x 12 accumulators a thread, held
//              over all tiles), written once at the end;
//   all:       the dQ part = dS K (4 x 6 a thread, in the registers S^T and
//              dP^T held), staged in its own buffer; thread 0 adds it into
//              the zeroed dq by TMA reduce-add in the tile's turn, and passes
//              the turn on once the add has completed, after the next tile's
//              score products (which run meanwhile).
// Keys past Lk are masked (-inf); query rows past Lq load as zeros with lse
// 1e30 (p = 0), and their dq rows fall outside the reduce-add's map.
template <bool FULL_BIAS>
__global__ void __launch_bounds__(f32bwd96::THREADS, 1)
    flash_bwd_f32_96_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_dq, const FlashBwdParams p,
                            int* counters, int key_tiles) {
  // block-scope names: they hide the one-pass hd-64 kernels' TILE and STAGES
  using f32bwd96::BK, f32bwd96::BQ, f32bwd96::HD, f32bwd96::STAGES, f32bwd96::TILE;
  using f32bwd96::OFF_BAR, f32bwd96::OFF_DQ, f32bwd96::OFF_DS, f32bwd96::OFF_P,
      f32bwd96::OFF_RING, f32bwd96::OFF_ROWS, f32bwd96::OFF_TICKET, f32bwd96::load_tile;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const uint32_t k_s = base, v_s = base + TILE, p_s = base + OFF_P, ds_s = base + OFF_DS,
                 dq_s = base + OFF_DQ;
  const uint32_t bar_full = base + OFF_BAR, bar_kv = bar_full + STAGES * 8;
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar_full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int item = take_ticket(counters, base + OFF_TICKET);  // syncs
  const int kt = item % key_tiles, bh = item / key_tiles;
  const int b = bh / p.H, h = bh % p.H;
  const int nq = (p.Lq + BQ - 1) / BQ;
  int* turns = counters + 1 + static_cast<long>(bh) * nq;
  const float* lse_row = p.lse + static_cast<long>(bh) * p.Lqp;
  const float* del_row = p.delta + static_cast<long>(bh) * p.Lqp;
  // query tile qt (q, do, lse and delta rows) into stage qt % STAGES
  auto load_q_tile = [&](int qt) {
    const int s = qt % STAGES;
    const uint32_t full = bar_full + 8 * s, dst = base + OFF_RING + s * 2 * TILE;
    const uint32_t rows = base + OFF_ROWS + s * 2 * BQ * 4;
    mbar_expect_tx(full, 2 * TILE + 2 * BQ * 4);
    load_tile(dst, &tm_q, full, qt * BQ, h, b);
    load_tile(dst + TILE, &tm_do, full, qt * BQ, h, b);
    bulk_load(rows, lse_row + qt * BQ, BQ * 4, full);
    bulk_load(rows + BQ * 4, del_row + qt * BQ, BQ * 4, full);
  };
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * TILE);
    load_tile(k_s, &tm_k, bar_kv, kt * BK, h, b);
    load_tile(v_s, &tm_v, bar_kv, kt * BK, h, b);
    for (int qt = 0; qt < STAGES && qt < nq; ++qt) load_q_tile(qt);
  }

  // the scores' keys kr + 4 m (the additive term of each; a key past Lk is
  // masked) and queries qr + 8 n
  const int kr = 16 * (warp & 3) + (lane >> 3), qr = 32 * (warp >> 2) + (lane & 7);
  float kb[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int key = kt * BK + kr + 4 * m;
    kb[m] = key < p.Lk ? (p.kbias != nullptr ? p.kbias[static_cast<long>(b) * p.Lk + key] : 0.0f)
                       : -INFINITY;
  }
  // warps 0-3: dV += P^T dO; warps 4-7: dK += dS^T Q; all: the dQ part's
  // queries tq + 16 i, columns 2 td + 32 h + e
  const int grp = warp >> 2, tkc = (tid & 127) >> 3, tj = lane & 7;
  const int tq = tid >> 4, td = tid & 15;
  float acc[4][12];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j] = 0.0f;
  mbar_wait(bar_kv, 0);

  for (int qt = 0; qt < nq; ++qt) {
    const int s = qt % STAGES;
    mbar_wait(bar_full + 8 * s, (qt / STAGES) & 1);
    const uint32_t q_t = base + OFF_RING + s * 2 * TILE, do_t = q_t + TILE;
    const uint32_t rows_s = base + OFF_ROWS + s * 2 * BQ * 4;
    float st[4][4], dp[4][4];
    f32_pair_products<HD / 4>(st, dp, k_s, v_s, q_t, do_t, kr, qr);
    // the last tile's add has had the score products' time: pass its turn
    if (tid == 0 && qt > 0) pass_turn(turns + qt - 1, kt);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = qr + 8 * n;
      const float lse = __uint_as_float(lds_u32(rows_s + 4 * col)),
                  dl = __uint_as_float(lds_u32(rows_s + BQ * 4 + 4 * col));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float x = fmaf(st[m][n], p.scale, kb[m]);
        if (FULL_BIAS) {
          const int qrow = qt * BQ + col, key = kt * BK + kr + 4 * m;
          if (qrow < p.Lq && key < p.Lk) x += p.fbias[static_cast<long>(qrow) * p.Lk + key];
        }
        const float pv = expf(x - lse);
        sts_f32(f32_at(p_s, col, kr + 4 * m), pv);
        sts_f32(f32_at(ds_s, col, kr + 4 * m), pv * (dp[m][n] - dl) * p.scale);
      }
    }
    __syncthreads();  // P and dS are written
    f32_cols_product<1, 3>(acc, grp ? ds_s : p_s, grp ? q_t : do_t, tkc, tj);
    float dq[4][6];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) dq[i][j] = 0.0f;
    f32_dq96_product(dq, ds_s, k_s, tq, td);
    __syncthreads();  // the stage, P and dS are read; the dQ buffer's last add has completed
    if (tid == 0 && qt + STAGES < nq) load_q_tile(qt + STAGES);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int y = 0; y < 3; ++y)
        sts_f2(f32_at(dq_s, tq + 16 * i, 2 * td + 32 * y), dq[i][2 * y], dq[i][2 * y + 1]);
    fence_proxy_async();  // the dQ part, seen by TMA
    __syncthreads();      // the dQ part is staged
    if (tid == 0) {
      wait_turn(turns + qt, kt);
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
        tma_reduce_add_4d(&tm_dq, dq_s + (c << 13), 32 * c, qt * BQ, h, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (tid == 0) pass_turn(turns + nq - 1, kt);

  // dV (warps 0-3) or dK (warps 4-7): keys kt * 64 + 4 tkc + i
  float* out = grp ? static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh
                   : static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const long sl = grp ? p.dk_sl : p.dv_sl;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kt * BK + 4 * tkc + i;
    if (key < p.Lk)
#pragma unroll
      for (int hh = 0; hh < HD / 32; ++hh)
        *reinterpret_cast<float4*>(out + key * sl + 4 * tj + 32 * hh) =
            make_float4(acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2],
                        acc[i][4 * hh + 3]);
  }
}

inline bool fill_params(FlashBwdParams& p, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta, int B, int H,
                        int Lq, int Lk, int Lqp, const long* strides,
                        const float* kbias, const float* fbias, float scale, void* dq,
                        void* dk, void* dv) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lqp < Lq || Lqp % LQ_PAD != 0) return false;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.kbias = kbias;
  p.fbias = fbias;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  long* s[21] = {&p.q_sb,  &p.q_sh,  &p.q_sl,  &p.k_sb,  &p.k_sh,  &p.k_sl,  &p.v_sb,
                 &p.v_sh,  &p.v_sl,  &p.o_sb,  &p.o_sh,  &p.o_sl,  &p.dq_sb, &p.dq_sh,
                 &p.dq_sl, &p.dk_sb, &p.dk_sh, &p.dk_sl, &p.dv_sb, &p.dv_sh, &p.dv_sl};
  for (int i = 0; i < 21; ++i) *s[i] = strides[i];
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Lqp = Lqp;
  p.scale = scale;
  return true;
}

// a 2-D map (d, rows) over the f32 dq workspace (d = 64 or 96), boxes of 64
// rows x 32 floats (128 bytes), 128-byte swizzle: the dkvq kernels'
// reduce-adds
inline bool ws_map(CUtensorMap* m, float* ws, long rows, int d = BHD) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(d * 4)};
  cuuint32_t box[2] = {32, QB};
  cuuint32_t elem[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ws, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace nova

// delta and lse rows for the backward kernels (D = 64 or 96). strides: 6
// element strides, (batch, head, row) of o and do. lse (B, H, Lq) f32 contiguous; lse_out and
// delta_out (B*H, Lqp), Lqp a multiple of 128 >= Lq; log2_units: lse_out in units of
// log 2 (the bf16 kernel) or natural (the f32 kernels).
extern "C" int nova_flash_attention_bwd_prep(const void* o, const void* dout, const float* lse,
                                             int is_bf16, int B, int H, int Lq, int Lqp, int D,
                                             const long* strides, int log2_units, float* lse_out,
                                             float* delta_out, void* stream_ptr) {
  using namespace nova;
  if (B <= 0 || H <= 0 || Lq <= 0 || (D != BHD && D != 96) || Lqp < Lq || Lqp % LQ_PAD != 0)
    return cudaErrorInvalidValue;
  const long rows = static_cast<long>(B) * H * Lqp;
  const long blocks = (rows + PREP_THREADS - 1) / PREP_THREADS;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float mul = log2_units ? kBwdLog2e : 1.0f;
  const long* s = strides;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (is_bf16 && D == 96)
    flash_bwd_prep_kernel<__nv_bfloat16, 96><<<grid, PREP_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, H, Lq,
        Lqp, s[0], s[1], s[2], s[3], s[4], s[5], mul, lse_out, delta_out, rows);
  else if (is_bf16)
    flash_bwd_prep_kernel<__nv_bfloat16, BHD><<<grid, PREP_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, H, Lq,
        Lqp, s[0], s[1], s[2], s[3], s[4], s[5], mul, lse_out, delta_out, rows);
  else if (D == 96)
    flash_bwd_prep_kernel<float, 96><<<grid, PREP_THREADS, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), lse, H, Lq, Lqp, s[0],
        s[1], s[2], s[3], s[4], s[5], mul, lse_out, delta_out, rows);
  else
    flash_bwd_prep_kernel<float, BHD><<<grid, PREP_THREADS, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), lse, H, Lq, Lqp, s[0],
        s[1], s[2], s[3], s[4], s[5], mul, lse_out, delta_out, rows);
  return cudaGetLastError();
}

// dK, dV and the dQ sums, bf16. strides: 18 element strides, (batch, head,
// row) of q, k, v, do, dk, dv. lse2 (units of log 2) and delta from the prep
// kernel; dq_ws (B*H, Lqp, 64) f32, zeroed. key_tiles, q_tiles and smem_bytes
// are the caller's launch plan, checked against this kernel's.
extern "C" int nova_flash_attention_bwd_dkvq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse2,
    const float* delta, int B, int H, int Lq, int Lk, int Lqp, int D, const long* strides,
    const float* kbias, const float* fbias, float scale, float* dq_ws, void* dk, void* dv,
    int key_tiles, int q_tiles, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D != BHD || Lqp < Lq || Lqp % LQ_PAD != 0)
    return cudaErrorInvalidValue;
  if (key_tiles != (Lk + KB - 1) / KB || q_tiles != (Lq + QB - 1) / QB ||
      smem_bytes != DKVQ_SMEM || static_cast<long>(B) * H > 65535 ||
      static_cast<long>(B) * H * Lqp > 2147483647L)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[5];
  const void* ptrs[4] = {q, k, v, dout};
  const int lens[4] = {Lq, Lk, Lk, Lq};
  for (int i = 0; i < 4; ++i)
    if (!bhld_map(&maps[i], ptrs[i], B, H, lens[i], strides + 3 * i)) return cudaErrorInvalidValue;
  if (!ws_map(&maps[4], dq_ws, static_cast<long>(B) * H * Lqp)) return cudaErrorInvalidValue;
  DkvqParams p;
  p.lse2 = lse2;
  p.delta = delta;
  p.kbias = kbias;
  p.fbias = fbias;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_sb = strides[12];
  p.dk_sh = strides[13];
  p.dk_sl = strides[14];
  p.dv_sb = strides[15];
  p.dv_sh = strides[16];
  p.dv_sl = strides[17];
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Lqp = Lqp;
  p.scale = scale;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // the full bias (read per score) gets its own instance
  auto kernel = fbias != nullptr ? flash_bwd_dkvq_kernel<true> : flash_bwd_dkvq_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKVQ_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(key_tiles, B * H), DKVQ_THREADS, DKVQ_SMEM, stream>>>(maps[0], maps[1], maps[2],
                                                                      maps[3], maps[4], p);
  return cudaGetLastError();
}

// the f32 dq workspace (B*H, Lqp, D) times scale -> bf16 dq, D = 64 or 96;
// strides: (batch, head, row)
extern "C" int nova_flash_attention_bwd_dq_cast(const float* ws, int B, int H, int Lq, int Lqp,
                                                int D, const long* strides, float scale,
                                                void* dq, void* stream_ptr) {
  using namespace nova;
  if (B <= 0 || H <= 0 || Lq <= 0 || (D != BHD && D != 96) || Lqp < Lq)
    return cudaErrorInvalidValue;
  const long chunks = static_cast<long>(B) * H * Lq * (D / 8);
  const long blocks = (chunks + CAST_THREADS - 1) / CAST_THREADS;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  auto kernel = D == 96 ? flash_bwd_dq_cast_kernel<96> : flash_bwd_dq_cast_kernel<BHD>;
  kernel<<<static_cast<unsigned>(blocks), CAST_THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      ws, H, Lq, Lqp, strides[0], strides[1], strides[2], scale, static_cast<__nv_bfloat16*>(dq),
      chunks);
  return cudaGetLastError();
}

// dK, dV and dQ, f32, in one pass. strides: 21 element strides, (batch,
// head, row) of q, k, v, do, dq, dk, dv in turn; lse (natural log) and delta
// (B*H, Lqp) from the prep kernel; dq zeroed (the kernel adds into it).
// key_tiles, q_tiles and smem_bytes are the caller's launch plan, checked
// against this kernel's.
extern "C" int nova_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, int B, int H, int Lq, int Lk, int Lqp, int D, const long* strides,
    const float* kbias, const float* fbias, float scale, void* dq, void* dk, void* dv,
    int key_tiles, int q_tiles, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  FlashBwdParams p;
  if (D != BHD || !fill_params(p, q, k, v, dout, lse, delta, B, H, Lq, Lk, Lqp, strides, kbias,
                               fbias, scale, dq, dk, dv))
    return cudaErrorInvalidValue;
  if (key_tiles != (Lk + FKB - 1) / FKB || q_tiles != (Lq + FQB - 1) / FQB ||
      smem_bytes != F32_SMEM || static_cast<long>(B) * H > 65535)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[5];
  const void* ptrs[5] = {q, k, v, dout, dq};
  const int lens[5] = {Lq, Lk, Lk, Lq, Lq};
  const int at[5] = {0, 3, 6, 9, 12};  // their strides' place in `strides`
  for (int i = 0; i < 5; ++i)
    if (!bhld_map(&maps[i], ptrs[i], B, H, lens[i], strides + at[i], FQB, 4))
      return cudaErrorInvalidValue;
  // the full bias (read per score) gets its own instance
  auto kernel = fbias != nullptr ? flash_bwd_f32_kernel<true> : flash_bwd_f32_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(key_tiles, B * H), F_THREADS, F32_SMEM, static_cast<cudaStream_t>(stream_ptr)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return cudaGetLastError();
}

// dK, dV and the dQ sums at head dim 96, bf16, in one pass (the dkvq96
// kernel). strides: 18 element strides, (batch, head, row) of q, k, v, do,
// dk, dv. lse2 (units of log 2) and delta (B*H, Lqp) from the prep kernel;
// dq_ws (B*H, Lqp, 96) f32, written by the kernel (key tile 0 stores, the
// others add); counters (1 + B*H*q_tiles) int32, zeroed here on the stream
// before the launch. key_tiles, q_tiles and smem_bytes are the caller's
// launch plan, checked against this kernel's; the grid is key_tiles * B * H
// blocks.
extern "C" int nova_flash_attention_bwd_dkvq96(
    const void* q, const void* k, const void* v, const void* dout, const float* lse2,
    const float* delta, int B, int H, int Lq, int Lk, int Lqp, int D, const long* strides,
    const float* kbias, const float* fbias, float scale, float* dq_ws, void* dk, void* dv,
    int* counters, int key_tiles, int q_tiles, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D != bwd96::HD || Lqp < Lq || Lqp % LQ_PAD != 0)
    return cudaErrorInvalidValue;
  const long blocks = static_cast<long>(key_tiles) * B * H;
  if (key_tiles != (Lk + bwd96::BK - 1) / bwd96::BK || q_tiles != (Lq + bwd96::BQ - 1) / bwd96::BQ ||
      smem_bytes != bwd96::SMEM || blocks > 2147483647L ||
      static_cast<long>(B) * H * Lqp > 2147483647L)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[5];
  const void* ptrs[4] = {q, k, v, dout};
  const int lens[4] = {Lq, Lk, Lk, Lq};
  for (int i = 0; i < 4; ++i)
    if (!bhld_map(&maps[i], ptrs[i], B, H, lens[i], strides + 3 * i, 64, 2, bwd96::HD))
      return cudaErrorInvalidValue;
  if (!ws_map(&maps[4], dq_ws, static_cast<long>(B) * H * Lqp, bwd96::HD))
    return cudaErrorInvalidValue;
  Dkvq96Params p;
  p.lse2 = lse2;
  p.delta = delta;
  p.kbias = kbias;
  p.fbias = fbias;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.counters = counters;
  p.dk_sb = strides[12];
  p.dk_sh = strides[13];
  p.dk_sl = strides[14];
  p.dv_sb = strides[15];
  p.dv_sh = strides[16];
  p.dv_sl = strides[17];
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Lqp = Lqp;
  p.key_tiles = key_tiles;
  p.scale = scale;
  // the full bias (read per score) gets its own instance
  auto kernel = fbias != nullptr ? flash_bwd_dkvq96_kernel<true> : flash_bwd_dkvq96_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd96::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counters, 0, (1 + static_cast<size_t>(B) * H * q_tiles) * sizeof(int),
                        static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), bwd96::THREADS, bwd96::SMEM,
           static_cast<cudaStream_t>(stream_ptr)>>>(maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return cudaGetLastError();
}

// dK, dV and dQ at head dim 96, f32, in one pass (the f32_96 kernel): the
// f32 one-pass kernel's arguments (21 strides: q, k, v, do, dq, dk, dv; lse
// in natural units; dq zeroed, the kernel adds into it) and counters (1 +
// B*H*q_tiles) int32, zeroed here on the stream before the launch.
// key_tiles, q_tiles and smem_bytes are the caller's launch plan, checked
// against this kernel's; the grid is key_tiles * B * H blocks.
extern "C" int nova_flash_attention_bwd_f32_96(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, int B, int H, int Lq, int Lk, int Lqp, int D, const long* strides,
    const float* kbias, const float* fbias, float scale, void* dq, void* dk, void* dv,
    int* counters, int key_tiles, int q_tiles, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  FlashBwdParams p;
  if (D != f32bwd96::HD || !fill_params(p, q, k, v, dout, lse, delta, B, H, Lq, Lk, Lqp, strides,
                                        kbias, fbias, scale, dq, dk, dv))
    return cudaErrorInvalidValue;
  const long blocks = static_cast<long>(key_tiles) * B * H;
  if (key_tiles != (Lk + f32bwd96::BK - 1) / f32bwd96::BK ||
      q_tiles != (Lq + f32bwd96::BQ - 1) / f32bwd96::BQ || smem_bytes != f32bwd96::SMEM ||
      blocks > 2147483647L)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[5];
  const void* ptrs[5] = {q, k, v, dout, dq};
  const int lens[5] = {Lq, Lk, Lk, Lq, Lq};
  const int at[5] = {0, 3, 6, 9, 12};  // their strides' place in `strides`
  for (int i = 0; i < 5; ++i)
    if (!bhld_map(&maps[i], ptrs[i], B, H, lens[i], strides + at[i], 64, 4, f32bwd96::HD))
      return cudaErrorInvalidValue;
  auto kernel = fbias != nullptr ? flash_bwd_f32_96_kernel<true> : flash_bwd_f32_96_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f32bwd96::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counters, 0, (1 + static_cast<size_t>(B) * H * q_tiles) * sizeof(int),
                        static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), f32bwd96::THREADS, f32bwd96::SMEM,
           static_cast<cudaStream_t>(stream_ptr)>>>(maps[0], maps[1], maps[2], maps[3], maps[4], p,
                                                    counters, key_tiles);
  return cudaGetLastError();
}
