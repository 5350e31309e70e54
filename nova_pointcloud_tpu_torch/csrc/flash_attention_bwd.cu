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
// f32 inputs take the prep kernel and two SIMT kernels (one thread per query
// row for dQ, per key row for dK/dV), written for exactness, not speed.
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
// both warpgroups do element work.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "quant.cuh"

namespace nova {

constexpr float kBwdLog2e = 1.4426950408889634f;
constexpr float kDeadLse = 1e30f;  // lse of a row with every key masked, and of padding

__device__ __forceinline__ float ex2b(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

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

constexpr int BHD = 64;        // head dim
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

template <typename T>
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
  // XLA's order on the CPU: each half of 32 summed in sequence from 0, then
  // the two halves; __fmul_rn / __fadd_rn keep nvcc from contracting to fma
  float half[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < BHD / PER; ++c) {
    float x[PER], y[PER];
    load16(orow, c, x);
    load16(drow, c, y);
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      float& acc = half[(c * PER + e) / (BHD / 2)];
      acc = __fadd_rn(acc, __fmul_rn(y[e], x[e]));
    }
  }
  delta_out[i] = __fadd_rn(__fadd_rn(0.0f, half[0]), half[1]);
  lse_out[i] = __fmul_rn(lse[static_cast<long>(bh) * Lq + row], lse_mul);
}

// ---------------------------------------------------------------------------
// cast: f32 dq workspace (B*H, Lqp, 64) -> bf16 dq (strided), times the
// softmax scale the dkvq kernel leaves out of ds
// ---------------------------------------------------------------------------
constexpr int CAST_THREADS = 256;

__global__ void __launch_bounds__(CAST_THREADS)
    flash_bwd_dq_cast_kernel(const float* ws, int H, int Lq, int Lqp, long sb, long sh, long sl,
                             float scale, __nv_bfloat16* dq, long chunks) {
  const long i = static_cast<long>(blockIdx.x) * CAST_THREADS + threadIdx.x;
  if (i >= chunks) return;  // one chunk: 8 values of one row
  const long r = i / (BHD / 8);
  const int c = static_cast<int>(i % (BHD / 8)) * 8;
  const int bh = static_cast<int>(r / Lq), row = static_cast<int>(r % Lq);
  const float4* src =
      reinterpret_cast<const float4*>(ws + (static_cast<long>(bh) * Lqp + row) * BHD + c);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` has completed; traps (a launch
// error, not a hung card) if it never does
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// adds a 64-row x 32-float box from (128B-swizzled) shared memory into the
// f32 workspace at (col, row)
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map, uint32_t src, int col,
                                                  int row) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row)
      : "memory");
}
// shared-memory loads and stores by 32-bit shared address: through a
// generic pointer the compiler emits generic ld / st, several times slower
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts_u32(uint32_t addr, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}


// wgmma shared-memory descriptor of a 128B-swizzled tile with 128-byte rows
// (64 bf16) and 8-row groups 1024 bytes apart. K-major (the product's k
// dimension along the row): LBO unused (1). MN-major (k along the rows): one
// 64-wide swizzle atom along m / n, so LBO is never stepped; it is set to the
// same 1024 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, bool mn_major) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(mn_major ? 64 : 1) << 16;
  d |= static_cast<uint64_t>(64) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma uses across this point
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(unsigned (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define NOVA_WG_D32                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define NOVA_WG_REGS                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A B, both from shared memory; TA / TB: MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NOVA_WG_REGS
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : NOVA_WG_D32
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
// d (64 x 64, f32) (+)= A B, A (64 x 16 bf16) from registers, B from shared
// memory; TB: MN-major
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NOVA_WG_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : NOVA_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

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
        st[i] = ex2b(x - ((e & 1) ? l2.y : l2.x));
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
// f32 inputs: SIMT, exact f32 sums in the JAX kernels' formulas
// ---------------------------------------------------------------------------
constexpr int FQ = 128;  // dQ: query rows per block, one per thread
constexpr int FK = 32;   // dQ: keys per shared-memory tile
constexpr int FKV = 64;  // dK/dV: key rows per block, one per thread
constexpr int FQT = 32;  // dK/dV: queries per shared-memory tile

__global__ void __launch_bounds__(FQ) flash_bwd_dq_f32_kernel(FlashBwdParams p) {
  __shared__ __align__(16) float Ks[FK][BHD];
  __shared__ __align__(16) float Vs[FK][BHD];
  const int nq = (p.Lq + FQ - 1) / FQ;
  const int qt = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x;
  const int row = qt * FQ + tid;
  const bool live = row < p.Lq;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* DO = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;

  float q[BHD], od[BHD], dq[BHD];
  {
    const float4* qr = reinterpret_cast<const float4*>(Q + static_cast<long>(live ? row : 0) * p.q_sl);
    const float4* orr =
        reinterpret_cast<const float4*>(DO + static_cast<long>(live ? row : 0) * p.o_sl);
#pragma unroll
    for (int d = 0; d < BHD / 4; ++d) {
      const float4 a = live ? qr[d] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 c = live ? orr[d] : make_float4(0.f, 0.f, 0.f, 0.f);
      q[4 * d] = a.x * p.scale;  // q * sm_scale, as the TPU kernel
      q[4 * d + 1] = a.y * p.scale;
      q[4 * d + 2] = a.z * p.scale;
      q[4 * d + 3] = a.w * p.scale;
      od[4 * d] = c.x;
      od[4 * d + 1] = c.y;
      od[4 * d + 2] = c.z;
      od[4 * d + 3] = c.w;
    }
  }
#pragma unroll
  for (int d = 0; d < BHD; ++d) dq[d] = 0.0f;
  const float lse = p.lse[static_cast<long>(bh) * p.Lqp + row];
  const float dl = p.delta[static_cast<long>(bh) * p.Lqp + row];
  const float* kb = p.kbias != nullptr ? p.kbias + static_cast<long>(b) * p.Lk : nullptr;
  const float* fb =
      p.fbias != nullptr ? p.fbias + static_cast<long>(live ? row : 0) * p.Lk : nullptr;

  const int ntiles = (p.Lk + FK - 1) / FK;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int c = tid; c < FK * BHD / 4; c += FQ) {
      const int r = c / (BHD / 4), col = (c % (BHD / 4)) * 4;
      const int key = kt * FK + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < p.Lk) {
        kv = *reinterpret_cast<const float4*>(K + static_cast<long>(key) * p.k_sl + col);
        vv = *reinterpret_cast<const float4*>(V + static_cast<long>(key) * p.v_sl + col);
      }
      *reinterpret_cast<float4*>(&Ks[r][col]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][col]) = vv;
    }
    __syncthreads();
    for (int j = 0; j < FK; ++j) {
      const int key = kt * FK + j;
      if (key >= p.Lk) break;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int d = 0; d < BHD; ++d) {
        s += q[d] * Ks[j][d];
        dp += od[d] * Vs[j][d];
      }
      if (kb != nullptr) s += kb[key];
      if (fb != nullptr) s += fb[key];
      const float pr = expf(s - lse);
      const float ds = pr * (dp - dl) * p.scale;
#pragma unroll
      for (int d = 0; d < BHD; ++d) dq[d] += ds * Ks[j][d];
    }
  }
  if (!live) return;
  float* DQ = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + static_cast<long>(row) * p.dq_sl;
#pragma unroll
  for (int d = 0; d < BHD / 4; ++d)
    reinterpret_cast<float4*>(DQ)[d] =
        make_float4(dq[4 * d], dq[4 * d + 1], dq[4 * d + 2], dq[4 * d + 3]);
}

// one thread per key row: k, dk, dv in registers, the block's v rows in
// shared memory (padded rows, conflict-free), query tiles read by broadcast
__global__ void __launch_bounds__(FKV) flash_bwd_dkv_f32_kernel(FlashBwdParams p) {
  __shared__ float Vown[FKV][BHD + 1];
  __shared__ __align__(16) float Qs[FQT][BHD];
  __shared__ __align__(16) float Ds[FQT][BHD];
  __shared__ float ls[FQT], dls[FQT];
  const int nk = (p.Lk + FKV - 1) / FKV;
  const int kt = blockIdx.x % nk, bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x;
  const int key = kt * FKV + tid;
  const bool live = key < p.Lk;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* DO = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* LSE = p.lse + static_cast<long>(bh) * p.Lqp;
  const float* DEL = p.delta + static_cast<long>(bh) * p.Lqp;

  float k[BHD], dk[BHD], dv[BHD];
  {
    const float4* kr = reinterpret_cast<const float4*>(K + static_cast<long>(live ? key : 0) * p.k_sl);
    const float4* vr = reinterpret_cast<const float4*>(V + static_cast<long>(live ? key : 0) * p.v_sl);
#pragma unroll
    for (int d = 0; d < BHD / 4; ++d) {
      const float4 a = live ? kr[d] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 c = live ? vr[d] : make_float4(0.f, 0.f, 0.f, 0.f);
      k[4 * d] = a.x;
      k[4 * d + 1] = a.y;
      k[4 * d + 2] = a.z;
      k[4 * d + 3] = a.w;
      Vown[tid][4 * d] = c.x;
      Vown[tid][4 * d + 1] = c.y;
      Vown[tid][4 * d + 2] = c.z;
      Vown[tid][4 * d + 3] = c.w;
    }
  }
#pragma unroll
  for (int d = 0; d < BHD; ++d) {
    dk[d] = 0.0f;
    dv[d] = 0.0f;
  }
  const float kbv = (p.kbias != nullptr && live) ? p.kbias[static_cast<long>(b) * p.Lk + key] : 0.0f;

  const int ntiles = (p.Lq + FQT - 1) / FQT;
  for (int qt = 0; qt < ntiles; ++qt) {
    __syncthreads();
    for (int c = tid; c < FQT * BHD / 4; c += FKV) {
      const int r = c / (BHD / 4), col = (c % (BHD / 4)) * 4;
      const int row = qt * FQT + r;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), ov = qv;
      if (row < p.Lq) {
        qv = *reinterpret_cast<const float4*>(Q + static_cast<long>(row) * p.q_sl + col);
        ov = *reinterpret_cast<const float4*>(DO + static_cast<long>(row) * p.o_sl + col);
      }
      *reinterpret_cast<float4*>(&Qs[r][col]) = qv;
      *reinterpret_cast<float4*>(&Ds[r][col]) = ov;
    }
    if (tid < FQT) {
      ls[tid] = LSE[qt * FQT + tid];  // padded rows: 1e30
      dls[tid] = DEL[qt * FQT + tid];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < FQT; ++i) {
      const int row = qt * FQT + i;
      if (row >= p.Lq) break;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int d = 0; d < BHD; ++d) {
        s += Qs[i][d] * p.scale * k[d];
        dp += Ds[i][d] * Vown[tid][d];
      }
      s += kbv;
      if (p.fbias != nullptr) s += p.fbias[static_cast<long>(row) * p.Lk + key];
      const float pr = expf(s - ls[i]);
      const float ds = pr * (dp - dls[i]) * p.scale;
#pragma unroll
      for (int d = 0; d < BHD; ++d) {
        dv[d] += pr * Ds[i][d];
        dk[d] += ds * Qs[i][d];
      }
    }
  }
  if (!live) return;
  float* DK = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh + static_cast<long>(key) * p.dk_sl;
  float* DV = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh + static_cast<long>(key) * p.dv_sl;
#pragma unroll
  for (int d = 0; d < BHD / 4; ++d) {
    reinterpret_cast<float4*>(DK)[d] =
        make_float4(dk[4 * d], dk[4 * d + 1], dk[4 * d + 2], dk[4 * d + 3]);
    reinterpret_cast<float4*>(DV)[d] =
        make_float4(dv[4 * d], dv[4 * d + 1], dv[4 * d + 2], dv[4 * d + 3]);
  }
}


inline bool fill_params(FlashBwdParams& p, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta, int B, int H,
                        int Lq, int Lk, int Lqp, int D, const long* strides,
                        const float* kbias, const float* fbias, float scale, void* dq,
                        void* dk, void* dv) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D != BHD) return false;
  if (Lqp < Lq || Lqp % LQ_PAD != 0) return false;
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

// cuTensorMapEncodeTiled of libcuda, found at run time (the library links no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// a 4-D map (d, L, H, B) over a bf16 (B, H, L, 64) view, boxes of 64 rows,
// 128-byte swizzle, rows past L read as zeros
inline bool bhld_map(CUtensorMap* m, const void* ptr, int B, int H, int L, const long* s) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  for (int i = 0; i < 3; ++i)
    if (s[i] <= 0 || (s[i] * 2) % 16 != 0) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(BHD), static_cast<cuuint64_t>(L),
                        static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[2] * 2), static_cast<cuuint64_t>(s[1] * 2),
                           static_cast<cuuint64_t>(s[0] * 2)};
  cuuint32_t box[4] = {BHD, 64, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D map (64, rows) over the f32 dq workspace, boxes of 64 rows x 32
// floats (128 bytes), 128-byte swizzle: the dkvq kernel's reduce-adds
inline bool ws_map(CUtensorMap* m, float* ws, long rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(BHD), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(BHD * 4)};
  cuuint32_t box[2] = {32, QB};
  cuuint32_t elem[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ws, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace nova

// delta and lse rows for the backward kernels. strides: 6 element strides,
// (batch, head, row) of o and do. lse (B, H, Lq) f32 contiguous; lse_out and
// delta_out (B*H, Lqp), Lqp a multiple of 128 >= Lq; log2_units: lse_out in units of
// log 2 (the bf16 kernel) or natural (the f32 kernels).
extern "C" int nova_flash_attention_bwd_prep(const void* o, const void* dout, const float* lse,
                                             int is_bf16, int B, int H, int Lq, int Lqp, int D,
                                             const long* strides, int log2_units, float* lse_out,
                                             float* delta_out, void* stream_ptr) {
  using namespace nova;
  if (B <= 0 || H <= 0 || Lq <= 0 || D != BHD || Lqp < Lq || Lqp % LQ_PAD != 0)
    return cudaErrorInvalidValue;
  const long rows = static_cast<long>(B) * H * Lqp;
  const long blocks = (rows + PREP_THREADS - 1) / PREP_THREADS;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float mul = log2_units ? kBwdLog2e : 1.0f;
  const long* s = strides;
  if (is_bf16)
    flash_bwd_prep_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), PREP_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, H, Lq,
        Lqp, s[0], s[1], s[2], s[3], s[4], s[5], mul, lse_out, delta_out, rows);
  else
    flash_bwd_prep_kernel<float><<<static_cast<unsigned>(blocks), PREP_THREADS, 0, stream>>>(
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

// the f32 dq workspace (B*H, Lqp, 64) times scale -> bf16 dq; strides:
// (batch, head, row)
extern "C" int nova_flash_attention_bwd_dq_cast(const float* ws, int B, int H, int Lq, int Lqp,
                                                int D, const long* strides, float scale,
                                                void* dq, void* stream_ptr) {
  using namespace nova;
  if (B <= 0 || H <= 0 || Lq <= 0 || D != BHD || Lqp < Lq) return cudaErrorInvalidValue;
  const long chunks = static_cast<long>(B) * H * Lq * (BHD / 8);
  const long blocks = (chunks + CAST_THREADS - 1) / CAST_THREADS;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  flash_bwd_dq_cast_kernel<<<static_cast<unsigned>(blocks), CAST_THREADS, 0,
                             static_cast<cudaStream_t>(stream_ptr)>>>(
      ws, H, Lq, Lqp, strides[0], strides[1], strides[2], scale, static_cast<__nv_bfloat16*>(dq),
      chunks);
  return cudaGetLastError();
}

// f32: strides, 21 element strides, (batch, head, row) of q, k, v, do, dq,
// dk, dv in turn; lse (natural log) and delta (B*H, Lqp) from the prep kernel.
extern "C" int nova_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, int is_bf16, int B, int H, int Lq, int Lk, int Lqp, int D,
    const long* strides, const float* kbias, const float* fbias, float scale, void* dq,
    void* dk, void* dv, void* stream_ptr) {
  using namespace nova;
  FlashBwdParams p;
  if (is_bf16 || !fill_params(p, q, k, v, dout, lse, delta, B, H, Lq, Lk, Lqp, D, strides, kbias,
                              fbias, scale, dq, dk, dv))
    return cudaErrorInvalidValue;
  const long blocks = static_cast<long>(B) * H * ((Lk + FKV - 1) / FKV);
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  flash_bwd_dkv_f32_kernel<<<static_cast<unsigned>(blocks), FKV, 0,
                             static_cast<cudaStream_t>(stream_ptr)>>>(p);
  return cudaGetLastError();
}

extern "C" int nova_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, int is_bf16, int B, int H, int Lq, int Lk, int Lqp, int D,
    const long* strides, const float* kbias, const float* fbias, float scale, void* dq,
    void* dk, void* dv, void* stream_ptr) {
  using namespace nova;
  FlashBwdParams p;
  if (is_bf16 || !fill_params(p, q, k, v, dout, lse, delta, B, H, Lq, Lk, Lqp, D, strides, kbias,
                              fbias, scale, dq, dk, dv))
    return cudaErrorInvalidValue;
  const long blocks = static_cast<long>(B) * H * ((Lq + FQ - 1) / FQ);
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  flash_bwd_dq_f32_kernel<<<static_cast<unsigned>(blocks), FQ, 0,
                            static_cast<cudaStream_t>(stream_ptr)>>>(p);
  return cudaGetLastError();
}
