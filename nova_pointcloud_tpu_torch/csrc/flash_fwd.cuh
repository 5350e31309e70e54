// The forward attention main loop for Hopper (sm_90a), shared by
// flash_attention.cu (online softmax, bf16) and flash_attention_static.cu
// (calibrated softmax offset, bf16 or int8 score core).
//
// Work item: 192 query rows of one (batch, head), three consumer
// warpgroups of 64 rows each (wgmma's M); at head dim 96, 128 rows in two
// warpgroups (Tiling below). The grid is persistent: one block
// of 384 threads per SM walks the items blockIdx.x, + gridDim.x, ...,
// ordered so that the query tiles of one (batch, head) run at the same time
// and share its K and V in L2. Across items a block's key tiles form one
// sequence g = 0, 1, ..., streamed by TMA through a ring of STAGES stages (K,
// V, and with a key bias the tile's 128 bias values by bulk copy), 4-D maps
// (d, L, H, B) over the strided (B, H, L, d) views, 128B swizzle (64B for
// int8; at head dim 96 a tile is three 32-column panels of 64-byte rows in
// the 64B swizzle, one TMA box each, and the wgmma descriptors step over
// them). No producer warp: the first stages and each warpgroup's q rows (two
// slots per warpgroup, the next item's rows loaded while this item runs) are
// issued by a thread of each warpgroup; a stage is refilled by the thread of
// the warpgroup that releases it last (a shared counter), so no warpgroup
// waits for another to issue a copy.
//
// Per key tile g, each warpgroup:
//   S_g = Q K_g^T         wgmma m64n128k16 bf16 (or m64n128k32 s8, 64B
//                         swizzle, 32B at head dim 96: 8-bit wgmma is
//                         K-major only), both
//                         operands K-major in shared memory
//   O  += P_{g-1} V_{g-1}  wgmma m64n64k16 (m64n96k16 at head dim 96), P
//                         from registers (the previous tile's
//                         probabilities: S's accumulator layout is the
//                         A-fragment layout), V MN-major (transposed)
// issued back to back, then the softmax of S_g while P_{g-1} V_{g-1} runs;
// while S_g runs, the warpgroup releases tile g - 2 and waits for tile
// g + 1's copies, off the path from the scores to the softmax. The static
// kernel also sums l on the tensor cores, P times a tile of ones (the JAX
// kernel's p [v | 1]). The warpgroups take turns issuing (named barriers
// 1 .. NWG, in rotation), so one's softmax runs while the others' products
// run. Three warpgroups, not two: a warpgroup's own chain (its products,
// its exponentials, its p packed into registers) leaves the tensor cores
// idle between its tiles, and a third chain fills that gap (PERF.md). The
// loop keeps no integer division: the item and key tile of a step advance
// by counting.
//
// Ragged tails: TMA zero-fills rows past L within each (b, h); keys past Lk
// score -inf by index in the last tile only; query rows past Lq are not
// stored. Scores are kept in units of log 2 (one ex2 a probability).
//
// Head dim 96 (Tiling<96>): O is 64 x 96 f32 a warpgroup, 48 registers a
// thread against 32, which three warpgroups of 384 threads (168 registers
// at most) cannot hold beside S and P, and a K + V stage is 48 KB: two
// warpgroups (255 registers at most) and three stages, 199,552 bytes. With
// three stages the tile whose stage is refilled is released right after
// its p v (the step after its scores), not at the next step, so the copy
// of tile g + 1 still runs behind a whole step. The static kernel's bf16
// core rounds q * hd^-0.5 to bf16 in shared memory once an item, as the
// JAX kernel scales q (96^-0.5 is not a power of 2, unlike 64^-0.5). The
// int8 core at head dim 96 reads q and k codes as three 32-byte panels of
// a 96-byte row each, in the 32B swizzle (one TMA box a panel, at the bf16
// panels' places), one s8 k-step of 32 a panel; its scale stays on the f32
// scores, folded into the dequant factor.
#pragma once

#include "hopper.cuh"

namespace nova {
namespace fwd {

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF: the running max starts here
constexpr int BK = 128;            // keys per tile
constexpr int KB_SLOT = BK * 4;    // a tile's key-bias values, 512 bytes
constexpr int TURN = 2 * 128;  // threads of a turn barrier: the waiting and the arriving warpgroup

// the tiling and the shared-memory layout at head dim HD (64 or 96)
template <int HD_>
struct Tiling {
  static_assert(HD_ == 64 || HD_ == 96, "the forward kernels take head dim 64 or 96");
  static constexpr int HD = HD_;
  static constexpr int NWG = HD == 64 ? 3 : 2;       // consumer warpgroups
  static constexpr int BQ = 64 * NWG;                // query rows of a work item
  static constexpr int THREADS = 128 * NWG;
  static constexpr int STAGES = HD == 64 ? 4 : 3;    // depth of the K / V ring
  static constexpr int Q_SLOT = 64 * HD * 2;   // a warpgroup's q rows, 8 / 12 KB (int8: 4 KB used)
  static constexpr int KV_SLOT = BK * HD * 2;  // a K or V tile, 16 / 24 KB (int8 K: 8 KB used)
  // HD 96: a 32-column panel of a warpgroup's q rows, of a K or V tile
  static constexpr int Q_PANEL = 64 * 64, KV_PANEL = BK * 64;
  static constexpr int OFF_Q = 0;                            // + (2 w + slot) Q_SLOT
  static constexpr int OFF_K = 2 * NWG * Q_SLOT;             // + s KV_SLOT
  static constexpr int OFF_V = OFF_K + STAGES * KV_SLOT;     // + s KV_SLOT
  static constexpr int OFF_KB = OFF_V + STAGES * KV_SLOT;    // + s KB_SLOT
  static constexpr int OFF_BAR = OFF_KB + STAGES * KB_SLOT;  // full[s]; then q[2 w + slot]
  static constexpr int N_BARS = STAGES + 2 * NWG;
  static constexpr int OFF_CNT = OFF_BAR + N_BARS * 8;       // release counts, one a stage
  static constexpr int OFF_ONES = ((OFF_CNT + STAGES * 4 + 127) / 128) * 128;  // 256 bytes of ones
  static constexpr int SMEM = OFF_ONES + 256 + 1024;        // + 1024 to align the swizzled tiles
  static_assert(SMEM <= 232448, "over the 227 KB a block can use");
};

struct Params {
  void* o;                // (B, H, Lq, HD) at o strides; bf16, or f32 when !o_bf16
  float* lse;             // (B*H, Lq), natural log (online softmax only)
  const float* kbias;     // key bias rows (B, >= Lk) at row stride kb_sb, or nullptr
  const float* fbias;     // (Lq, Lk), or nullptr
  const float* smax;      // static: the calibrated max logit
  const float* a_q;       // static int8 core: the calibrated amax of q and k
  const float* a_k;
  long kb_sb;
  long o_sb, o_sh, o_sl;
  int H, Lq, Lk, nq, nk, items, o_bf16;
  float scale;
};

// four f32 loads, volatile so that they stay in order with the others: a
// full bias (a check path, read per score) keeps at most four loads in flight
// and leaves the registers to the scores
__device__ __forceinline__ void ld4_in_order(float (&v)[4], const float* a, const float* b,
                                             const float* c, const float* d) {
  asm volatile(
      "ld.volatile.global.f32 %0, [%4];\n\tld.volatile.global.f32 %1, [%5];\n\t"
      "ld.volatile.global.f32 %2, [%6];\n\tld.volatile.global.f32 %3, [%7];"
      : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
      : "l"(a), "l"(b), "l"(c), "l"(d));
}

// STATIC: p = bf16(exp(min(s + kbias - smax, 20))), o = p v / max(sum p,
// 1e-30); else the online softmax, o = softmax(s + bias) v and the lse.
// INT8: the s8 score core (q, k int8 codes), s = int32 * a_q a_k / 127^2 *
// scale. KBIAS: a key bias; FBIAS: a full (Lq, Lk) bias. HD: the head dim.
template <int HD, bool STATIC, bool INT8, bool KBIAS, bool FBIAS>
__global__ void __launch_bounds__(Tiling<HD>::THREADS, 1)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Params p) {
  static_assert(!(STATIC && FBIAS), "the static kernel takes a key bias only");
  static_assert(!INT8 || STATIC, "the int8 score core is the static kernel's");
  using C = Tiling<HD>;
  constexpr int NWG = C::NWG, BQ = C::BQ, STAGES = C::STAGES, Q_SLOT = C::Q_SLOT,
                KV_SLOT = C::KV_SLOT, OFF_Q = C::OFF_Q, OFF_K = C::OFF_K, OFF_V = C::OFF_V,
                OFF_KB = C::OFF_KB, OFF_BAR = C::OFF_BAR, N_BARS = C::N_BARS,
                OFF_CNT = C::OFF_CNT, OFF_ONES = C::OFF_ONES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  // the warpgroup index through a shuffle: the compiler then knows it is
  // warp-uniform, and the descriptors built from it stay uniform
  const int w = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int lt = tid & 127, wi = lt >> 5, lane = lt & 31, g = lane >> 2, t = lane & 3;
  const int nk = p.nk, nq = p.nq;
  const int n_items = (p.items - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
  const int G = n_items * nk;  // key tiles of this block, over all its items
  const uint32_t bar_full = base + OFF_BAR, bar_q = bar_full + STAGES * 8, cnt = base + OFF_CNT;

  if (tid == 0) {
    for (int i = 0; i < N_BARS; ++i) mbar_init(bar_full + 8 * i, 1);
    for (int s = 0; s < STAGES; ++s) sts_u32(cnt + 4 * s, 0u);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (STATIC && tid < 64) {  // the ones that sum p into l on the tensor cores
    sts_u32(base + OFF_ONES + 4 * tid, 0x3F803F80u);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  auto item_bh_qt = [&](int j, int& bh, int& qt) {
    const int it = static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x);
    bh = it / nq;
    qt = it - bh * nq;
  };
  // key tile kt of (batch b, head h) into stage s
  auto issue_kv = [&](int s, int kt, int b, int h) {
    const uint32_t full = bar_full + 8 * s;
    int kb_bytes = 0;
    if (KBIAS) kb_bytes = ((min(BK, p.Lk - kt * BK) + 3) & ~3) * 4;
    mbar_expect_tx(full, (INT8 ? BK * HD : KV_SLOT) + KV_SLOT + kb_bytes);
    if constexpr (HD == 64) {
      tma_load_4d(base + OFF_K + s * KV_SLOT, &tm_k, full, 0, kt * BK, h, b);
      tma_load_4d(base + OFF_V + s * KV_SLOT, &tm_v, full, 0, kt * BK, h, b);
    } else {
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) {
        tma_load_4d(base + OFF_K + s * KV_SLOT + c * C::KV_PANEL, &tm_k, full, 32 * c, kt * BK, h,
                    b);
        tma_load_4d(base + OFF_V + s * KV_SLOT + c * C::KV_PANEL, &tm_v, full, 32 * c, kt * BK, h,
                    b);
      }
    }
    if (KBIAS)
      bulk_load(base + OFF_KB + s * KB_SLOT, p.kbias + b * p.kb_sb + kt * BK, kb_bytes, full);
  };
  // this warpgroup's 64 q rows of item j into its slot j & 1
  auto issue_q = [&](int j) {
    int bh, qt;
    item_bh_qt(j, bh, qt);
    const int b = bh / p.H, h = bh - b * p.H, slot = 2 * w + (j & 1);
    mbar_expect_tx(bar_q + 8 * slot, INT8 ? 64 * HD : Q_SLOT);
    if constexpr (HD == 64) {
      tma_load_4d(base + OFF_Q + slot * Q_SLOT, &tm_q, bar_q + 8 * slot, 0, qt * BQ + 64 * w, h, b);
    } else {
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
        tma_load_4d(base + OFF_Q + slot * Q_SLOT + c * C::Q_PANEL, &tm_q, bar_q + 8 * slot, 32 * c,
                    qt * BQ + 64 * w, h, b);
    }
  };
  // the key tile that refills a stage next: tile STAGES of the sequence,
  // kt_r of item j_r, (b_r, h_r); kept by every thread, advanced at every
  // release, so the integer divisions run once an item
  int j_r = 0, kt_r = 0, b_r = 0, h_r = 0;
  auto item_bh = [&](int j, int& b, int& h) {
    int bh, qt;
    item_bh_qt(j, bh, qt);
    b = bh / p.H;
    h = bh - b * p.H;
  };
  item_bh(0, b_r, h_r);
  for (int gi = 0; gi < STAGES && gi < G; ++gi) {
    if (tid == 0) issue_kv(gi, kt_r, b_r, h_r);
    if (++kt_r == nk) {
      kt_r = 0;
      if (++j_r < n_items) item_bh(j_r, b_r, h_r);
    }
  }
  if (lt == 0) {
    issue_q(0);
    if (n_items > 1) issue_q(1);
  }

  // raw score -> units of log 2; static: the offset -smax in those units
  // (the static bf16 core at head dim 96 has the scale on q already)
  float c_scale = p.scale * kLog2e, c_off = 0.0f;
  if constexpr (STATIC && !INT8 && HD != 64) c_scale = kLog2e;
  if (STATIC) {
    c_off = -__ldg(p.smax) * kLog2e;
    if (INT8)
      c_scale = fmaxf(__ldg(p.a_q), 1e-30f) * fmaxf(__ldg(p.a_k), 1e-30f) / (127.0f * 127.0f) *
                p.scale * kLog2e;
  }
  constexpr float kClip = 20.0f * kLog2e;

  float o[HD / 2];
  // static: l of rows g (la[0]) and g + 8 (la[2]) as p (64 x 128) times a
  // 128 x 8 tile of ones, each column the row sum of the bf16 p that enters
  // p v, in f32 (the JAX kernel's p [v | 1])
  float la[4];
  unsigned pa[8][4];  // P of the previous tile as A fragments: keys 16 kk .. 16 kk + 15
  // rows g and g + 8 of the warp's 16: the running max, this thread's part
  // of the sum, the last tile's rescale factors (online softmax)
  float m0 = kNegInf * kLog2e, m1 = m0, l0 = 0.0f, l1 = 0.0f, al0 = 1.0f, al1 = 1.0f;
  bool rescale = false;  // some row of this warp moved its max in the last tile
  constexpr float kLazy = 8.0f;

  // the finished item j: o / l in the output dtype, the lse; then a fresh
  // max and sum for the next item
  auto finish = [&](int j) {
    if (STATIC) {
      l0 = la[0];
      l1 = la[2];
    } else {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {  // a row's values sit in one quad
        l0 += __shfl_xor_sync(0xffffffffu, l0, x);
        l1 += __shfl_xor_sync(0xffffffffu, l1, x);
      }
    }
    int bh, qt;
    item_bh_qt(j, bh, qt);
    const int b = bh / p.H, h = bh - b * p.H;
    const int r0 = qt * BQ + 64 * w + 16 * wi + g, r1 = r0 + 8;
    float inv0, inv1;
    if (STATIC) {
      inv0 = 1.0f / fmaxf(l0, 1e-30f);
      inv1 = 1.0f / fmaxf(l1, 1e-30f);
    } else {  // a row whose keys are all masked by -inf has l = 0: o = 0
      inv0 = l0 == 0.0f ? 0.0f : 1.0f / l0;
      inv1 = l1 == 0.0f ? 0.0f : 1.0f / l1;
    }
    const long ob = b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const bool hi = (i >> 1) & 1;
      const int row = hi ? r1 : r0, col = 8 * (i >> 2) + 2 * t;
      const float inv = hi ? inv1 : inv0;
      if (row < p.Lq) {
        const long off = ob + row * p.o_sl + col;
        if (STATIC && !p.o_bf16)
          *reinterpret_cast<float2*>(static_cast<float*>(p.o) + off) =
              make_float2(o[i] * inv, o[i + 1] * inv);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.o) + off) =
              __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
      }
    }
    if (!STATIC && t == 0) {
      float* lse = p.lse + static_cast<long>(bh) * p.Lq;
      if (r0 < p.Lq) lse[r0] = l0 == 0.0f ? -kNegInf : m0 * kLn2 + logf(l0);
      if (r1 < p.Lq) lse[r1] = l1 == 0.0f ? -kNegInf : m1 * kLn2 + logf(l1);
    }
    m0 = m1 = kNegInf * kLog2e;
    l0 = l1 = 0.0f;
  };
  // a new item j: wait for its q rows; queue the next item's rows into the
  // other slot, whose last reader, item j - 1, is done
  auto open_item = [&](int j) {
    mbar_wait(bar_q + 8 * (2 * w + (j & 1)), (j >> 1) & 1);
    if (lt == 0 && j >= 1 && j + 1 < n_items) issue_q(j + 1);
    if constexpr (STATIC && !INT8 && HD != 64) {
      // q = bf16(q * scale) in place, 16 bytes a thread at a time (the
      // layout does not matter to an elementwise pass); then made visible
      // to wgmma and waited for by the whole warpgroup
      const uint32_t q_tile = base + OFF_Q + (2 * w + (j & 1)) * Q_SLOT;
#pragma unroll
      for (int i = 0; i < Q_SLOT / (16 * 128); ++i) {
        const uint32_t a = q_tile + 16 * (lt + 128 * i);
        uint4 v = lds_u4(a);
        unsigned* u = reinterpret_cast<unsigned*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          u[e] = pack_bf16(__uint_as_float(u[e] << 16) * p.scale,
                           __uint_as_float(u[e] & 0xFFFF0000u) * p.scale);
        sts_u4(a, v);
      }
      fence_proxy_async();
      named_sync(NWG + 1 + w, 128);
    }
  };
  // S = Q K^T of a tile of item j in stage s (one commit group)
  auto issue_s = [&](float (&sf)[64], int (&si)[64], int j, int s) {
    const uint32_t q_tile = base + OFF_Q + (2 * w + (j & 1)) * Q_SLOT;
    const uint32_t k_tile = base + OFF_K + s * KV_SLOT;
    if constexpr (INT8 && HD == 64) {
      const uint64_t da = desc_sw64(q_tile), db = desc_sw64(k_tile);
      wgmma_s8_n128(si, da, db, 0);
      wgmma_s8_n128(si, da + 2, db + 2, 1);  // k-step: 32 bytes
    } else if constexpr (INT8) {  // k-steps of 32 columns: one 32-byte panel each
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk)
        wgmma_s8_n128(si, desc_sw32(q_tile + kk * C::Q_PANEL),
                      desc_sw32(k_tile + kk * C::KV_PANEL), kk > 0);
    } else if constexpr (HD == 64) {
      const uint64_t da = desc_sw128(q_tile, false), db = desc_sw128(k_tile, false);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_n128(sf, da + 2 * kk, db + 2 * kk, kk > 0);
    } else {  // k-steps of 16 columns: two a 64-byte panel row, 32 bytes apart
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n128(sf, desc_sw64(q_tile + (kk >> 1) * C::Q_PANEL) + 2 * (kk & 1),
                      desc_sw64(k_tile + (kk >> 1) * C::KV_PANEL) + 2 * (kk & 1), kk > 0);
    }
    wgmma_commit();
  };
  // O (+)= P V of the tile in stage s (one commit group); k-step of 16
  // keys: 16 rows of 128 bytes (128 in the address field); a tile that
  // opens its item (first) overwrites O
  auto issue_pv = [&](int s, bool first) {
    const int acc = !first;
    if constexpr (HD == 64) {
      const uint64_t dv = desc_sw128(base + OFF_V + s * KV_SLOT, true);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs<1>(o, pa[kk], dv + 128 * kk, kk > 0 || acc);
    } else {  // three 32-column panels (LBO); k-step of 16 keys: 16 rows of 64 bytes (64)
      const uint64_t dv = desc_sw64_mn(base + OFF_V + s * KV_SLOT, C::KV_PANEL);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs_n96<1>(o, pa[kk], dv + 64 * kk, kk > 0 || acc);
    }
    if (STATIC) {  // every k-step reads the same ones
      const uint64_t d1 = desc_noswizzle(base + OFF_ONES, 128, 128);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs_n8(la, pa[kk], d1, kk > 0 || acc);
    }
    wgmma_commit();
  };
  // all warpgroups done with tile gi (in stage s): the last to say so
  // refills the stage with tile gi + STAGES
  auto release = [&](int gi, int s) {
    if (lt == 0 && atom_add_shared(cnt + 4 * s, 1u) % NWG == NWG - 1 && gi + STAGES < G)
      issue_kv(s, kt_r, b_r, h_r);
    if (++kt_r == nk) {
      kt_r = 0;
      if (++j_r < n_items) item_bh(j_r, b_r, h_r);
    }
  };
  // the softmax of the scores of key tile kt of item j (stage s), in
  // place: p (f32) in sf; the online softmax's rescale factors in al0 / al1
  auto softmax = [&](float (&sf)[64], int (&si)[64], int j, int kt, int s) {
    if (INT8) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sf[i] = static_cast<float>(si[i]);
    }
    const int kvalid = p.Lk - kt * BK;  // keys of this tile below Lk
    const bool ragged = kvalid < BK;
    const uint32_t kb_tile = base + OFF_KB + s * KB_SLOT;
    // this thread's columns: 8 jn + 2 t and + 1, rows g (e < 2) and g + 8
    if (STATIC) {
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        float2 kv = make_float2(c_off, c_off);
        if (KBIAS) {
          kv = lds_f2(kb_tile + (8 * jn + 2 * t) * 4);
          kv.x = fmaf(kv.x, kLog2e, c_off);
          kv.y = fmaf(kv.y, kLog2e, c_off);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          float x = fminf(fmaf(sf[i], c_scale, (e & 1) ? kv.y : kv.x), kClip);
          if (ragged && 8 * jn + 2 * t + (e & 1) >= kvalid) x = -INFINITY;
          sf[i] = ex2(x);
        }
      }
      return;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (!KBIAS && !FBIAS) {  // raw scores: the scale (> 0) commutes with the max
      if (ragged) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (8 * (i >> 2) + 2 * t + (i & 1) >= kvalid) sf[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sf[i], sf[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sf[i + 2], sf[i + 3]));
      }
      mx0 *= c_scale;
      mx1 *= c_scale;
    } else {
      // full bias: this thread's rows (clamped to Lq - 1: rows past Lq are
      // not stored) from key tile kt on
      const float *fb0 = nullptr, *fb1 = nullptr;
      if (FBIAS) {
        int bh, qt;
        item_bh_qt(j, bh, qt);
        const int r0 = qt * BQ + 64 * w + 16 * wi + g;
        fb0 = p.fbias + static_cast<long>(min(r0, p.Lq - 1)) * p.Lk + kt * BK;
        fb1 = p.fbias + static_cast<long>(min(r0 + 8, p.Lq - 1)) * p.Lk + kt * BK;
      }
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        float2 kv = make_float2(0.0f, 0.0f);
        if (KBIAS) {
          kv = lds_f2(kb_tile + (8 * jn + 2 * t) * 4);
          kv.x *= kLog2e;
          kv.y *= kLog2e;
        }
        float fb[4];  // rows g, g + 8 x columns 8 jn + 2 t, + 1 (clamped below Lk)
        if (FBIAS) {
          const int c0 = min(8 * jn + 2 * t, kvalid - 1), c1 = min(8 * jn + 2 * t + 1, kvalid - 1);
          ld4_in_order(fb, fb0 + c0, fb0 + c1, fb1 + c0, fb1 + c1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e, c = 8 * jn + 2 * t + (e & 1);
          float x = fmaf(sf[i], c_scale, (e & 1) ? kv.y : kv.x);
          if (FBIAS) x = fmaf(fb[e], kLog2e, x);
          if (ragged && c >= kvalid) x = -INFINITY;
          sf[i] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {  // a row's values sit in one quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // the running max moves only when the tile's max passes it by more than
    // 2^8 (8 in units of log 2): p stays below 2^8, exact in f32 and bf16,
    // and O is rescaled only in a warp where some row's max moved. o / l
    // and lse = m + log l are the same for any such m (the max of the row,
    // or a value up to 8 below it); m starts at -1e30 log2 e, finite
    const bool up0 = mx0 > m0 + kLazy, up1 = mx1 > m1 + kLazy;
    const float mn0 = up0 ? mx0 : m0, mn1 = up1 ? mx1 : m1;
    rescale = __any_sync(0xffffffffu, up0 || up1);
    al0 = ex2(m0 - mn0);
    al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.0f, rs1 = 0.0f;
    // without a bias the scale folds into the exponent's multiply-add
    const float mul = !KBIAS && !FBIAS ? c_scale : 1.0f;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      sf[i] = ex2(fmaf(sf[i], mul, -mn0));
      sf[i + 1] = ex2(fmaf(sf[i + 1], mul, -mn0));
      sf[i + 2] = ex2(fmaf(sf[i + 2], mul, -mn1));
      sf[i + 3] = ex2(fmaf(sf[i + 3], mul, -mn1));
      rs0 += sf[i] + sf[i + 1];
      rs1 += sf[i + 2] + sf[i + 3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
  };
  // p of key tile kt into the A fragments of its p v (static: and of l);
  // online: O rescaled to the new max
  auto keep_p = [&](const float (&sf)[64], int kt) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sf[8 * kk + 2 * e], sf[8 * kk + 2 * e + 1]);
    if (!STATIC && kt != 0 && rescale) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= ((i >> 1) & 1) ? al1 : al0;
    }
  };

  const int turn = 1 + w, next_turn = w + 1 == NWG ? 1 : w + 2;
  if (w == NWG - 1) named_arrive(1, TURN);  // warpgroup 0 takes the first turn
  {  // tile 0: its scores only
    open_item(0);
    mbar_wait(bar_full, 0);
    named_sync(turn, TURN);
    float sf[64];
    int si[64];
    wgmma_fence();
    issue_s(sf, si, 0, 0);
    named_arrive(next_turn, TURN);
    wgmma_wait<0>();
    if (INT8)
      fence_regs(si);
    else
      fence_regs(sf);
    if (G > 1) mbar_wait(bar_full + 8, 0);  // tile 1's K and V
    softmax(sf, si, 0, 0, 0);
    keep_p(sf, 0);
  }
  // tile gi (key tile kt of item j) and the one before it: its scores and
  // the previous tile's p v, back to back
  int j = nk == 1 ? 1 : 0, kt = nk == 1 ? 0 : 1;
  bool prev_first = true;  // tile gi - 1 opened its item
  for (int gi = 1; gi < G; ++gi) {
    const int s = gi % STAGES, sp = (gi - 1) % STAGES;  // tiles gi and gi - 1
    const bool opens = kt == 0;  // tile gi opens item j; tile gi - 1 closed item j - 1
    if (opens) open_item(j);
    named_sync(turn, TURN);
    float sf[64];
    int si[64];
    wgmma_fence();
    issue_s(sf, si, j, s);
    issue_pv(sp, prev_first);
    named_arrive(next_turn, TURN);
    // while S runs: tile gi - 2 is done (its p v was waited for in the last
    // step), and the next tile's K and V are waited for here, off the path
    // from the scores to the softmax (three stages: tile gi - 1 is released
    // once its p v is done, below)
    if (STAGES == 4 && gi >= 2) release(gi - 2, (gi - 2) % STAGES);
    if (gi + 1 < G) mbar_wait(bar_full + 8 * ((gi + 1) % STAGES), ((gi + 1) / STAGES) & 1);
    if (opens) {  // item j - 1 is done once its last p v is
      wgmma_wait<0>();
      fence_regs(o);
      if (STATIC) fence_regs(la);
      fence_regs(pa);
      if (STAGES == 3) release(gi - 1, (gi - 1) % STAGES);
      finish(j - 1);
    } else {
      wgmma_wait<1>();
    }
    if (INT8)
      fence_regs(si);
    else
      fence_regs(sf);
    softmax(sf, si, j, kt, s);
    if (!opens) {
      wgmma_wait<0>();
      fence_regs(o);
      if (STATIC) fence_regs(la);
      fence_regs(pa);
      if (STAGES == 3) release(gi - 1, (gi - 1) % STAGES);
    }
    keep_p(sf, kt);
    prev_first = opens;
    if (++kt == nk) {
      kt = 0;
      ++j;
    }
  }
  // the last tile's p v
  named_sync(turn, TURN);
  wgmma_fence();
  issue_pv((G - 1) % STAGES, prev_first);
  if (w != NWG - 1) named_arrive(next_turn, TURN);
  wgmma_wait<0>();
  fence_regs(o);
  if (STATIC) fence_regs(la);
  finish(n_items - 1);
}

// the launch plan's checks, shared by both entry points: nq, nk, items
template <int HD>
inline bool plan(int B, int H, int Lq, int Lk, int grid, int smem_bytes, Params& p) {
  constexpr int BQ = Tiling<HD>::BQ;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || grid <= 0) return false;
  p.nq = (Lq + BQ - 1) / BQ;
  p.nk = (Lk + BK - 1) / BK;
  const long items = static_cast<long>(B) * H * p.nq;
  if (items > 2147483647L || static_cast<long>(p.nk) * (items / grid + 1) > 2147483647L)
    return false;
  p.items = static_cast<int>(items);
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  return grid <= items && smem_bytes == Tiling<HD>::SMEM;
}

// a key bias the kernel can bulk-copy: 16-byte aligned rows of at least
// Lk rounded up to 4 floats (or one shared row, stride 0, when Lk % 4 == 0)
inline bool key_bias_ok(const float* kb, long kb_sb, int Lk) {
  if (kb == nullptr) return true;
  if (reinterpret_cast<uintptr_t>(kb) % 16 != 0 || kb_sb % 4 != 0 || kb_sb < 0) return false;
  return kb_sb == 0 ? Lk % 4 == 0 : kb_sb >= ((Lk + 3) & ~3);
}

template <int HD, bool STATIC, bool INT8, bool KBIAS, bool FBIAS>
inline cudaError_t launch(const CUtensorMap* maps, const Params& p, int grid,
                          cudaStream_t stream) {
  using C = Tiling<HD>;
  auto kernel = attn_fwd_kernel<HD, STATIC, INT8, KBIAS, FBIAS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // namespace fwd
}  // namespace nova
