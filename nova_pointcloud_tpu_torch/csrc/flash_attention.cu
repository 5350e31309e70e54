// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the forward Pallas TPU kernel of flash_attention
// (nova_pointcloud_tpu/ops/pallas/flash_attention.py, _fwd_kernel):
//
//   o   = softmax(q k^T / sqrt(d) + bias) v          in q's dtype
//   lse = m + log(l)                                 f32, (B*H, Lq), natural log
//
// by online softmax over key tiles (running max m from -1e30, running sum
// l), f32 accumulation, so the (Lq, Lk) scores never reach device memory.
// bias: none, a key bias (B, Lk) read with the batch index bh / H (no per-head
// copies), or a full bias (Lq, Lk) shared by every (batch, head); -inf
// entries mask. A row whose keys are all masked by -inf gives o = 0 and
// lse = +1e30, as the TPU kernel; the backward (flash_attention_bwd.cu)
// reads that lse.
//
// q, k, v, o are (B, H, L, d) views given by their batch / head / row strides
// with d contiguous, so the model's (B, L, H, d) projections are read and
// written in place. bf16 takes d = 64 or 96 (flash_fwd.cuh's Tiling), f32
// d = 64 or 96 (f32fwd::Tiling).
//
// At d = 96 (the NOVA-1.4B ViTs) the bound is 4*B*H*Lq*Lk*96 FLOPs: 0.326 ms
// at (2, 16, 5120, 96); the exponentials are two thirds of the products'
// share there, against one at d = 64.
//
// What bounds it on this card: operations. 4*B*H*Lq*Lk*d bf16 FLOPs (0.21 ms
// at B*H=192, L=2048, d=64 against the 989 TFLOP/s bf16 peak) against 0.2 GB
// of q, k, v, o (0.06 ms); and at d = 64 the exponentials: one ex2 a score
// on the special-function units (16 a cycle per SM) takes about as long as
// the score's share of the two products on the tensor cores. bf16 inputs run
// flash_fwd.cuh's main loop (attn_fwd_kernel): a persistent grid of 128-row
// items in two warpgroups, K / V tiles of 128 keys streamed by TMA, q k^T and
// p v on wgmma (p from registers), the softmax in units of log 2 with the
// scale folded into one fused multiply-add, the two warpgroups taking turns
// on the tensor cores so that one's exponentials overlap the other's
// products. A full bias gets its own instance, read from device memory per
// score.
//
// f32 inputs (the route exists for exactness: f32 FFMA only, no TF32, no
// tensor core; expf, not __expf) run flash_fwd_f32_kernel, bound by the
// same 4*B*H*Lq*Lk*d FLOPs at the 67 TFLOP/s f32 peak (0.80 ms at (8, 16,
// 1280, 64)). Its design keeps the FFMA pipe fed: Q once and K / V tiles
// of 64 keys by TMA in the 128B swizzle (f32_chunk, the f32 backward's
// layout), both products register-tiled (8 x 8 outputs a thread, each
// 16-byte shared-memory load feeding 16-32 FFMAs, every load one
// wavefront), the online softmax once a 64-key tile, K of the next tile
// loading behind this tile's P V and V behind the next tile's Q K^T, two
// blocks an SM. Built with fused multiply-add: there is no rounding
// identity to keep with a reference, unlike the int8 kernels. At d = 96
// (4.81 ms at (2, 16, 5120, 96)) a block takes 64 query rows, a thread 4
// rows x 8 keys of S and 4 rows x 12 columns of O, each row three 128-byte
// boxes: 91,408 bytes, still two blocks an SM; each K load feeds 16 FFMAs
// there, against 32 at d = 64.

#include "flash_fwd.cuh"
#include "quant.cuh"

namespace nova {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

// ---------------------------------------------------------------------------
// f32: one register-tiled SIMT pass in f32 FFMA
// ---------------------------------------------------------------------------
namespace f32fwd {
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 128;  // each NI rows x 8 keys of S and NI rows x D / 8 columns of O
// the tiling at head dim D: NI query rows a thread, 16 NI a block (128 at
// 64; 64 at 96, where 128 rows would take 132 KB of shared memory, one block
// an SM, and 8 x 12 accumulators of O beside 8 x 8 of S would spill); a
// 64-row f32 tile is D / 32 boxes of 64 rows x 128 bytes
template <int D>
struct Tiling {
  static_assert(D == 64 || D == 96, "the f32 forward takes head dim 64 or 96");
  static constexpr int NI = D == 64 ? 8 : 4;
  static constexpr int BQ = 16 * NI;                // query rows a block
  static constexpr int NB = D / 32;                 // 128-byte boxes a row
  static constexpr int TILE = 64 * D * 4;           // 64 rows of q, K or V
  static constexpr int PTILE = 64 * 64 * 4;         // 64 rows of P
  // bytes from one warp pair's 8 NI rows to the next, in Q and in P
  static constexpr int QGRP = NI == 8 ? TILE : 8 * NI * 128;
  static constexpr int PGRP = NI == 8 ? PTILE : 8 * NI * 128;
  static constexpr int OFF_Q = 0;                   // BQ / 64 tiles
  static constexpr int OFF_K = (BQ / 64) * TILE;
  static constexpr int OFF_V = OFF_K + TILE;
  static constexpr int OFF_P = OFF_V + TILE;        // BQ / 64 tiles, rows as Q's
  static constexpr int OFF_KB = OFF_P + (BQ / 64) * PTILE;  // the key tile's bias values
  static constexpr int OFF_BAR = OFF_KB + BK * 4;   // K (with Q at the first tile, the key bias), V
  // + alignment: two blocks an SM (99,600 bytes at 64, 91,408 at 96)
  static constexpr int SMEM = OFF_BAR + 2 * 8 + 1024;
  static_assert(2 * (SMEM + 1024) <= 233472, "two blocks an SM");
};

// the launch plan (the caller's, checked): one block a (BQ-row query tile,
// batch*head), the shared memory of the layout above
template <int D>
inline bool plan(int B, int H, int Lq, int grid, int smem_bytes) {
  constexpr int BQ = Tiling<D>::BQ;
  const long blocks = static_cast<long>(B) * H * ((Lq + BQ - 1) / BQ);
  return blocks == grid && smem_bytes == Tiling<D>::SMEM;
}
}  // namespace f32fwd

struct F32FwdParams {
  float* o;
  float* lse;          // (B*H, Lq)
  const float* kbias;  // key bias rows (B, >= Lk) at row stride kb_sb, or nullptr
  const float* fbias;  // (Lq, Lk) or nullptr
  long kb_sb;
  long o_sb, o_sh, o_sl;  // strides in elements: batch, head, row
  int H, Lq, Lk;
  float scale;
};

// One block of 128 threads a (BQ-row query tile, batch*head). Q is loaded
// once by TMA (BQ / 64 tiles of 64 x D f32 in the 128B swizzle of
// f32_chunk), K and V tiles of 64 keys stream through one buffer each:
// K[kt + 1] loads while the block runs the softmax and P V of tile kt,
// V[kt + 1] while it runs S of tile kt + 1. Thread (warp w, lane = 8 ti +
// tj) owns query rows r_i = 8 NI (w >> 1) + 4 (w & 1) + ti + 8 i and, per
// tile, keys tj + 8 j of S = Q K^T (i < NI, j < 8): each of its 16-byte
// loads of K feeds 4 NI FFMAs, of Q 32, and every load of a warp reads 8
// distinct 16-byte chunks at distinct banks (rows r & 7 distinct at one
// chunk, broadcast to the lanes that share them). The softmax scale is put
// on the f32 scores (fmaf(s, scale, bias): at d = 64 it is 2^-3, the same as
// scaling q first). The online softmax runs once a tile: the row max by
// shuffles among the 8 lanes of a row, alpha = exp(m - m') on the O
// accumulators, p = exp(x - m') to shared memory, l kept as each lane's
// partial sum. P rows are written and read by the same warp (__syncwarp); O
// += P V takes the thread's rows by 4-key chunks of P and its columns 4 tj +
// 32 h + e of V (h < D / 32), each load feeding 4 NI or 32 FFMAs. Keys past
// Lk are masked (-inf); query rows past Lq load as zeros and are not stored.
// A row whose keys are all masked gives o = 0 and lse = +1e30.
template <int D, bool KBIAS, bool FBIAS>
__global__ void __launch_bounds__(f32fwd::THREADS, 2)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const F32FwdParams p) {
  using namespace f32fwd;
  using C = Tiling<D>;
  constexpr int NI = C::NI, BQ = C::BQ, NB = C::NB, TILE = C::TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int nq = (p.Lq + BQ - 1) / BQ, nk = (p.Lk + BK - 1) / BK;
  const int bh = blockIdx.x / nq, qt = blockIdx.x - bh * nq;
  const int b = bh / p.H, h = bh - b * p.H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const int ti = lane >> 3, tj = lane & 7;
  const uint32_t q_s = base + C::OFF_Q, k_s = base + C::OFF_K, v_s = base + C::OFF_V,
                 p_s = base + C::OFF_P, kb_s = base + C::OFF_KB;
  const uint32_t bar_k = base + C::OFF_BAR, bar_v = bar_k + 8;
  // the thread's rows within their group of 8 NI: ra + 8 i, all with r & 7 = ra
  const int ra = 4 * (warp & 1) + ti;
  // f32_chunk(tile, ra + 8 i, c) = (t ^ ((c & 7) << 4)) + ((c >> 3) << 13) + (i << 10)
  // with t = group + (ra << 7) + (ra << 4); for K rows tj + 8 j likewise
  const uint32_t t_q = q_s + (warp >> 1) * C::QGRP + (ra << 7) + (ra << 4);
  const uint32_t t_p = p_s + (warp >> 1) * C::PGRP + (ra << 7) + (ra << 4);
  const uint32_t t_k = k_s + (tj << 7) + (tj << 4);
  // chunk tj of V row key: (t_v ^ ((key & 7) << 4)) + (key << 7)
  const uint32_t t_v = v_s + (tj << 4);
  const int row0 = qt * BQ + 8 * NI * (warp >> 1) + ra;  // query row of r_0; r_i = row0 + 8 i

  auto load_k = [&](int kt, int extra) {  // K tile kt and its key bias (thread 0)
    const int kb_bytes = KBIAS ? ((min(BK, p.Lk - kt * BK) + 3) & ~3) * 4 : 0;
    mbar_expect_tx(bar_k, TILE + kb_bytes + extra);
#pragma unroll
    for (int c = 0; c < NB; ++c) tma_load_4d(k_s + (c << 13), &tm_k, bar_k, 32 * c, kt * BK, h, b);
    if (KBIAS) bulk_load(kb_s, p.kbias + b * p.kb_sb + kt * BK, kb_bytes, bar_k);
  };
  auto load_v = [&](int kt) {
    mbar_expect_tx(bar_v, TILE);
#pragma unroll
    for (int c = 0; c < NB; ++c) tma_load_4d(v_s + (c << 13), &tm_v, bar_v, 32 * c, kt * BK, h, b);
  };
  if (tid == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_k(0, (BQ / 64) * TILE);
#pragma unroll
    for (int t = 0; t < BQ / 64; ++t)
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_4d(q_s + t * TILE + (c << 13), &tm_q, bar_k, 32 * c, qt * BQ + 64 * t, h, b);
    load_v(0);
  }

  float o[NI][4 * NB], m[NI], l[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) o[i][j] = 0.0f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(bar_k, kt & 1);
    // s[i][j] = sum_d Q[r_i][d] K[kt * 64 + tj + 8 j][d], by 4-column chunks
    float s[NI][8];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < D / 4; ++c) {
      const uint32_t xc = (c & 7) << 4, hc = (c >> 3) << 13;
      const uint32_t qa = (t_q ^ xc) + hc, ka = (t_k ^ xc) + hc;
      float4 qv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) qv[i] = lds_f4(qa + (i << 10));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = lds_f4(ka + (j << 10));
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }
    // the additive term of the thread's keys; a key past Lk is masked
    float kb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kt * BK + tj + 8 * j;
      kb[j] = key < p.Lk ? (KBIAS ? __uint_as_float(lds_u32(kb_s + 4 * (tj + 8 * j))) : 0.0f)
                         : -INFINITY;
    }
    __syncthreads();  // K and the key bias are read
    if (tid == 0 && kt + 1 < nk) load_k(kt + 1, 0);

    // online softmax of the tile's scores, once a tile
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = fmaf(s[i][j], p.scale, kb[j]);
        if (FBIAS) {
          const int row = row0 + 8 * i, key = kt * BK + tj + 8 * j;
          if (row < p.Lq && key < p.Lk) x += p.fbias[static_cast<long>(row) * p.Lk + key];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        ps += s[i][j];
      }
      l[i] = fmaf(l[i], alpha, ps);
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j) o[i][j] *= alpha;
    }
    // P[r_i][tj + 8 j] = f32_at(p tile, ra + 8 i, tj + 8 j): chunk 2 j + (tj >> 2)
    {
      const uint32_t pb = (t_p ^ ((tj >> 2) << 4)) + ((tj & 3) << 2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t pj = (pb ^ ((2 * (j & 3)) << 4)) + ((j >> 2) << 13);
#pragma unroll
        for (int i = 0; i < NI; ++i) sts_f32(pj + (i << 10), s[i][j]);
      }
    }
    __syncwarp();  // the warp's P rows are written
    mbar_wait(bar_v, kt & 1);
    // o[i][4 h + e] += sum_key P[r_i][key] V[key][4 tj + 32 h + e], keys 4c .. 4c + 3
#pragma unroll 1
    for (int cc = 0; cc < 8; ++cc) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 2 * cc + u;
        const uint32_t pa = (t_p ^ ((c & 7) << 4)) + ((c >> 3) << 13);
        float4 pv[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) pv[i] = lds_f4(pa + (i << 10));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k8 = 4 * u + e;  // key & 7
          const uint32_t va = (t_v ^ (k8 << 4)) + (cc << 10) + (k8 << 7);
          float vv[4 * NB];
#pragma unroll
          for (int hh = 0; hh < NB; ++hh) {
            const float4 x = lds_f4(va + (hh << 13));
            vv[4 * hh] = x.x;
            vv[4 * hh + 1] = x.y;
            vv[4 * hh + 2] = x.z;
            vv[4 * hh + 3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const float a = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int j = 0; j < 4 * NB; ++j) o[i][j] = fmaf(a, vv[j], o[i][j]);
          }
        }
      }
    }
    __syncthreads();  // V is read
    if (tid == 0 && kt + 1 < nk) load_v(kt + 1);
  }

  // l over the row's 8 lanes; o / l to the strided o, lse per live row
  float* O = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int row = row0 + 8 * i;
    if (row >= p.Lq) continue;
    const bool dead = li == 0.0f;
    const float den = dead ? 1.0f : li;
    float* orow = O + static_cast<long>(row) * p.o_sl + 4 * tj;
#pragma unroll
    for (int hh = 0; hh < NB; ++hh)
      *reinterpret_cast<float4*>(orow + 32 * hh) =
          make_float4(o[i][4 * hh] / den, o[i][4 * hh + 1] / den, o[i][4 * hh + 2] / den,
                      o[i][4 * hh + 3] / den);
    if (tj == 0) p.lse[static_cast<long>(bh) * p.Lq + row] = dead ? -kNegInf : m[i] + logf(li);
  }
}

// the f32 route's launch at head dim D: the key bias and the full bias (read
// per score) get their own instances
template <int D>
inline cudaError_t launch_f32(const CUtensorMap* maps, const F32FwdParams& p, int grid,
                              cudaStream_t stream) {
  auto kernel = p.fbias != nullptr   ? flash_fwd_f32_kernel<D, false, true>
                : p.kbias != nullptr ? flash_fwd_f32_kernel<D, true, false>
                                     : flash_fwd_f32_kernel<D, false, false>;
  constexpr int SMEM = f32fwd::Tiling<D>::SMEM;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, f32fwd::THREADS, SMEM, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // namespace nova

// strides: 12 element strides, (batch, head, row) of q, k, v, o in turn.
// kbias: key bias rows at row stride kb_sb (16-byte aligned, see
// fwd::key_bias_ok) or nullptr; fbias (Lq, Lk) or nullptr. grid and
// smem_bytes are the caller's launch plan (bf16: fwd::plan's; f32:
// f32fwd::plan's), checked against the kernel's. D: 64 or 96.
extern "C" int nova_flash_attention(
    const void* q, const void* k, const void* v, int is_bf16,
    int B, int H, int Lq, int Lk, int D, const long* strides,
    const float* kbias, long kb_sb, const float* fbias, float scale,
    void* o, float* lse, int grid, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || (D != 64 && D != 96))
    return cudaErrorInvalidValue;
  if (!fwd::key_bias_ok(kbias, kb_sb, Lk) || (kbias != nullptr && fbias != nullptr))
    return cudaErrorInvalidValue;
  if (is_bf16) {
    fwd::Params p;
    if (!(D == 64 ? fwd::plan<64>(B, H, Lq, Lk, grid, smem_bytes, p)
                  : fwd::plan<96>(B, H, Lq, Lk, grid, smem_bytes, p)))
      return cudaErrorInvalidConfiguration;
    CUtensorMap maps[3];
    if (!bhld_map(&maps[0], q, B, H, Lq, strides, 64, 2, D) ||
        !bhld_map(&maps[1], k, B, H, Lk, strides + 3, fwd::BK, 2, D) ||
        !bhld_map(&maps[2], v, B, H, Lk, strides + 6, fwd::BK, 2, D))
      return cudaErrorInvalidValue;
    p.o = o;
    p.lse = lse;
    p.kbias = kbias;
    p.fbias = fbias;
    p.smax = p.a_q = p.a_k = nullptr;
    p.kb_sb = kb_sb;
    p.o_sb = strides[9], p.o_sh = strides[10], p.o_sl = strides[11];
    p.o_bf16 = 1;
    p.scale = scale;
    if (D == 96) {
      if (fbias != nullptr) return fwd::launch<96, false, false, false, true>(maps, p, grid, stream);
      if (kbias != nullptr) return fwd::launch<96, false, false, true, false>(maps, p, grid, stream);
      return fwd::launch<96, false, false, false, false>(maps, p, grid, stream);
    }
    if (fbias != nullptr) return fwd::launch<64, false, false, false, true>(maps, p, grid, stream);
    if (kbias != nullptr) return fwd::launch<64, false, false, true, false>(maps, p, grid, stream);
    return fwd::launch<64, false, false, false, false>(maps, p, grid, stream);
  }
  if (!(D == 64 ? f32fwd::plan<64>(B, H, Lq, grid, smem_bytes)
                : f32fwd::plan<96>(B, H, Lq, grid, smem_bytes)))
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[3];
  if (!bhld_map(&maps[0], q, B, H, Lq, strides, 64, 4, D) ||
      !bhld_map(&maps[1], k, B, H, Lk, strides + 3, 64, 4, D) ||
      !bhld_map(&maps[2], v, B, H, Lk, strides + 6, 64, 4, D))
    return cudaErrorInvalidValue;
  F32FwdParams p;
  p.o = static_cast<float*>(o);
  p.lse = lse;
  p.kbias = kbias;
  p.fbias = fbias;
  p.kb_sb = kb_sb;
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_sl = strides[11];
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.scale = scale;
  return D == 64 ? launch_f32<64>(maps, p, grid, stream) : launch_f32<96>(maps, p, grid, stream);
}
