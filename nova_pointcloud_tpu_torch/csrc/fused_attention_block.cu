// PreLN attention sub-block, int8 serving path, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_attention_block
// (nova_pointcloud_tpu/ops/pallas/fused_block.py, _attn_block_kernel and
// _attn_core_head):
//
//   q|k|v = q8(LN(x)) @ Wqkv * sx * s + b
//   y     = x + q8(softmax(q k^T / sqrt(hd)) v) @ Wo * sxo * so + bo
//
// Activation quant is static (calibrated a_in / a_av) or per row. The core
// runs in f32, bf16 (q, k, p, v rounded to bf16, f32 sums, scale applied
// after q.k) or int8 (per-row q/k/v quant, v-row scales folded into p); with
// a calibrated a_smax the softmax is exp(min(s - smax, 20)) over a
// denominator clamped at 1e-30, else a safe softmax. The weights come
// K-major: wqkv_t (3D, D) and wo_t (D, D) row-major. Head dim hd = D / H is
// 64 or 96; T is any count of tokens (the wrapper admits what the JAX
// model's fused rule sends here: ops/kernels/fused_block.attn_block_plan).
//
// What bounds it on this card: the int8 projections, 2*M*D*4D operations,
// plus the bf16 core, 4*B*T^2*D FLOPs (0.156 ms together at B=256, T=128,
// D=1024 against the int8 and bf16 peaks); the bytes are under half of
// that once q, k and v stay on chip. Design for the bf16 core at T = 128
// (the flagship's, and pc_d48w1536's at head dim 96), three launches:
//   (1) one block per row does LN + quant;
//   (2) attn_qkv_core_kernel<HD>: the QKV product and the attention core of
//       one (sample, head) tile in one persistent kernel, so the M x 3D qkv
//       tensor never reaches device memory. A producer warp streams the
//       sample's 128 int8 rows and the head's 3 HD weight rows (three
//       HD-row boxes of wqkv_t: q, k and v) by TMA through a ring; two
//       consumer warpgroups of 64 rows run s8 wgmma: at n = 192 over all
//       three at HD 64; at HD 96 (288 columns, over wgmma's 256) q|k at n =
//       192 (the two boxes lie one after the other) and v at n = 96, with 3
//       ring stages (4 do not fit beside the 96-wide K and V). The
//       epilogue dequantizes exactly as the GEMM's EPI_STORE does and rounds
//       to bf16: q stays in registers as the A fragments of S = Q K^T (the
//       accumulator's column pairs are the bf16 A-fragment layout), k and v
//       go to shared memory in the layout of the wgmma descriptors (HD 64:
//       128-byte rows, 128B swizzle; HD 96: 192-byte rows fit no 128B atom,
//       so three 32-column panels of 64-byte rows in the 64B swizzle, as
//       flash_fwd.cuh's Tiling<96>). S runs as wgmma m64n128k16, P V as
//       m64n64k16 (m64n96k16) with P from registers and V as a transposed
//       operand; the softmax in between in registers (scores in units of
//       log 2, p normalized in f32 before its bf16 rounding). The output is
//       quantized with the static a_av and stored 16 bytes a thread (a
//       transpose within each quad; HD 96's last 32 columns 8 bytes a
//       thread), or on the per-row path written in f32 for (2b) a row pass,
//       which needs the whole D-wide row. The producer loads the next tile
//       while the consumers run the core; tiles walk with the head fastest,
//       so the blocks running together share the sample's rows in L2 and
//       wqkv_t stays there;
//   (3) the out-projection on the wgmma GEMM (int8_wgmma.cuh), whose
//       epilogue adds bo and the residual.
// The bf16 core at any other T (the split route: T = 256 at 4096 points),
// a simple first design: the QKV product on the wgmma GEMM writing bf16
// qkv (M, 3D) through its EPI_STORE epilogue (the same dequantize-then-round
// as (2)), then attn_core_bf16_kernel<HD>: a block of 4 warps takes 64 query
// rows of one (sample, head), keys in chunks of 64 through shared memory
// (zero past T, and masked), mma.sync m16n8k16; two passes over the keys,
// the first for the row max and sum, the second for p = exp(.) / sum in f32,
// rounded to bf16, and P V; then the out-projection. The (M, 3D) bf16 qkv
// round trip is the price of this route (PERF.md).
// The f32 and int8 cores (off the driven paths) run the QKV product on the
// same GEMM writing f32 qkv, one thread per query row in the core (a block
// of T threads), and the same out-projection.

#include "int8_wgmma.cuh"
#include "tensor_core.cuh"

namespace nova {

constexpr int AT = 128;  // tokens per sample of the one-kernel route
enum { CORE_F32 = 0, CORE_BF16 = 1, CORE_INT8 = 2 };
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store_av(float v, long idx, const float* a_av, int8_t* av8,
                                         float* avf) {
  if (a_av != nullptr)
    av8[idx] = q8_rint(v * (1.0f / static_scale(a_av)));
  else
    avf[idx] = v;
}

namespace qkvc {

constexpr int BK = 128, CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int A_BYTES = AT * BK;                // 16 KB: the sample's rows
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BAR_KV_FREE = 1, BAR_KV_READY = 2;  // named barriers of both consumers

// the shared memory at head dim HD: the ring's stages (the A tile and the
// three HD x 128-byte weight boxes), K and V in bf16, a full and an empty
// mbarrier a stage, each consumer's column scales and biases
template <int HD>
struct Layout {
  static_assert(HD == 64 || HD == 96, "the one-kernel route takes head dim 64 or 96");
  static constexpr int BN = 3 * HD;             // the head's q, k and v columns
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int W_BOX = HD * BK;         // 8 / 12 KB: HD weight rows
  static constexpr int STAGE_BYTES = A_BYTES + 3 * W_BOX;
  static constexpr int KV_BYTES = AT * HD * 2;  // K or V, bf16
  static constexpr int KV_PANEL = AT * 64;      // HD 96: a 32-column panel of K or V
  static constexpr int OFF_K = STAGES * STAGE_BYTES;
  static constexpr int OFF_V = OFF_K + KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + KV_BYTES;  // full[s], then empty[s]
  static constexpr int OFF_EPI = OFF_BAR + 2 * STAGES * 8;
  static constexpr int EPI_BYTES = 2 * BN * 4;  // a consumer's column scales and biases
  static constexpr int SMEM = OFF_EPI + CONSUMERS * EPI_BYTES + 1024;  // + 1024 to align
  static_assert(SMEM <= 232448, "over the 227 KB a block can use");
};

struct Params {
  const float* sx;       // (M,) the rows' activation scales (the LN pass writes them)
  const float* w_scale;  // (3D,)
  const void* bias;      // (3D,)
  int bias_bf16;
  const float* smax;     // the calibrated max logit, or nullptr (safe softmax)
  const float* a_av;     // the output's calibrated amax, or nullptr: f32 avf
  int8_t* av8;
  float* avf;
  int H, D, tiles, ktiles;
  float scale;
};

// one of 4 words by an index known only at run time, without local memory
__device__ __forceinline__ unsigned pick4(const unsigned (&a)[4], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : a[3]));
}

// word t of each of the quad's four threads' w: u[k] = thread k's w[t]
__device__ __forceinline__ void quad_transpose(const unsigned (&w)[4], unsigned (&u)[4], int lane,
                                               int t) {
  unsigned rcv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)  // from thread (t + r) & 3: its word t
    rcv[r] = __shfl_sync(0xffffffffu, pick4(w, (t - r) & 3), (lane & ~3) | ((t + r) & 3));
#pragma unroll
  for (int k = 0; k < 4; ++k) u[k] = pick4(rcv, (k - t) & 3);  // thread k's word t
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    attn_qkv_core_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_w, const Params p) {
  using L = Layout<HD>;
  constexpr int STAGES = L::STAGES, STAGE_BYTES = L::STAGE_BYTES, W_BOX = L::W_BOX;
  constexpr int BN = L::BN, NH = (BN + 127) / 128;  // a thread's staged columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warp-uniform
  const uint32_t full = base + L::OFF_BAR, empty = full + STAGES * 8;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int b = tile / p.H, h = tile - b * p.H;
        for (int kt = 0; kt < p.ktiles; ++kt) {
          mbar_wait(empty + 8 * s, phase ^ 1);  // a fresh barrier passes parity 1
          const uint32_t dst = base + s * STAGE_BYTES, bar = full + 8 * s;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load_2d(dst, &tm_a, bar, kt * BK, b * AT);
#pragma unroll
          for (int i = 0; i < 3; ++i)  // rows h HD, D + h HD, 2 D + h HD: q, k, v
            tma_load_2d(dst + A_BYTES + i * W_BOX, &tm_w, bar, kt * BK, i * p.D + h * HD);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int c = wg - 1, lt = tid & 127, warp = lt >> 5, lane = lt & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t s_ws = base + L::OFF_EPI + c * L::EPI_BYTES, s_bs = s_ws + BN * 4;
  const uint32_t k_tile = base + L::OFF_K, v_tile = base + L::OFF_V;
  const bool st = p.smax != nullptr;
  const float c_scale = p.scale * kLog2e;  // raw score -> units of log 2
  const float c_off = st ? -__ldg(p.smax) * kLog2e : 0.0f;
  constexpr float kClip = 20.0f * kLog2e;
  const float out_inv = p.a_av != nullptr ? 1.0f / static_scale(p.a_av) : 0.0f;
  int s = 0;
  uint32_t phase = 0;
  int acc[96];                     // q|k|v at HD 64; q|k at HD 96
  int acc_v[HD == 96 ? 48 : 1];    // HD 96: v
  // the four k-steps of 32 bytes of the stage in slot `slot`
  auto issue = [&](int slot, bool first) {
    const uint64_t da = desc_sw128(base + slot * STAGE_BYTES + c * 64 * BK, false);
    const uint64_t dw = desc_sw128(base + slot * STAGE_BYTES + A_BYTES, false);
    if constexpr (HD == 64) {
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8_n192(acc, da + 2 * kk, dw + 2 * kk, !first || kk > 0);
    } else {
      const uint64_t dv = desc_sw128(base + slot * STAGE_BYTES + A_BYTES + 2 * W_BOX, false);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        wgmma_s8_n192(acc, da + 2 * kk, dw + 2 * kk, !first || kk > 0);
        wgmma_s8_n96(acc_v, da + 2 * kk, dv + 2 * kk, !first || kk > 0);
      }
    }
    wgmma_commit();
  };
  auto release = [&](int slot) {
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  };
  auto advance = [&]() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  };
  // accumulator element i of the tile's 3 HD columns
  auto acc_at = [&](int i) -> int {
    if constexpr (HD == 64)
      return acc[i];
    else
      return i < 96 ? acc[i] : acc_v[i - 96];
  };

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int b = tile / p.H, h = tile - b * p.H;
    // accumulator / score / output element i of this thread: row (query
    // or key) r0 + 8 ((i >> 1) & 1) of the sample, column 8 (i >> 2) +
    // 2 t + (i & 1); r0 & 7 == g
    const int r0 = 64 * c + 16 * warp + g;
    const long row0 = static_cast<long>(b) * AT + r0;
    // what the epilogue reads, loaded while the products run: the scales
    // and biases of columns lt, 128 + lt (and 256 + lt) of the tile's 3 HD,
    // and the two rows' activation scales
    float my_ws[NH], my_bs[NH];
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      my_ws[hh] = 0.0f;
      my_bs[hh] = 0.0f;
      const int cc = lt + 128 * hh;
      if (cc < BN) {
        const int col = HD == 64 ? (cc >> 6) * p.D + h * HD + (cc & 63)
                                 : (cc / HD) * p.D + h * HD + cc % HD;
        my_ws[hh] = p.w_scale[col];
        my_bs[hh] = ld_any(p.bias, col, p.bias_bf16);
      }
    }
    const float sx0 = p.sx[row0], sx1 = p.sx[row0 + 8];

    mbar_wait(full + 8 * s, phase);
    wgmma_fence();
    issue(s, true);
    int prev = s;
    advance();
    for (int kt = 1; kt < p.ktiles; ++kt) {
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
    if constexpr (HD == 96) fence_regs(acc_v);

    // this warpgroup's earlier reads of the staged columns ended before the
    // last tile's BAR_KV_READY; after BAR_KV_FREE both consumers' last P V
    // products are done with K and V
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      if (lt + 128 * hh < BN) {
        sts_u32(s_ws + 4 * (lt + 128 * hh), __float_as_uint(my_ws[hh]));
        sts_u32(s_bs + 4 * (lt + 128 * hh), __float_as_uint(my_bs[hh]));
      }
    named_sync(BAR_KV_FREE, 2 * 128);

    // q, k, v = acc * sx * w_scale + bias, rounded to bf16 (the GEMM's
    // EPI_STORE with a bf16 output): q into the A fragments of S (k-step kk
    // holds column groups 2 kk and 2 kk + 1), k and v into shared memory,
    // row = key; HD 64: 128 bytes a row, 16-byte chunk j at j ^ (key & 7);
    // HD 96: column group jj (of 12) in panel jj / 4, 64 bytes a row, chunk
    // jj % 4 at (jj % 4) ^ ((key / 2) % 4), the 64B swizzle
    unsigned qa[HD / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 w2 = lds_f2(s_ws + 4 * col), b2 = lds_f2(s_bs + 4 * col);
      const float v00 = static_cast<float>(acc_at(4 * j)) * sx0 * w2.x + b2.x;
      const float v01 = static_cast<float>(acc_at(4 * j + 1)) * sx0 * w2.y + b2.y;
      const float v10 = static_cast<float>(acc_at(4 * j + 2)) * sx1 * w2.x + b2.x;
      const float v11 = static_cast<float>(acc_at(4 * j + 3)) * sx1 * w2.y + b2.y;
      const unsigned u0 = pack_bf16(v00, v01), u1 = pack_bf16(v10, v11);
      if (j < HD / 8) {
        qa[j >> 1][2 * (j & 1)] = u0;
        qa[j >> 1][2 * (j & 1) + 1] = u1;
      } else if constexpr (HD == 64) {
        const uint32_t dst = (j < 16 ? k_tile : v_tile) + (((j & 7) ^ g) << 4) + 4 * t;
        sts_u32(dst + r0 * 128, u0);
        sts_u32(dst + (r0 + 8) * 128, u1);
      } else {
        const bool is_k = j < 2 * HD / 8;
        const int jj = is_k ? j - HD / 8 : j - 2 * HD / 8;
        const uint32_t dst = (is_k ? k_tile : v_tile) + (jj >> 2) * L::KV_PANEL +
                             (((jj & 3) ^ (g >> 1)) << 4) + 4 * t;  // (key / 2) % 4 == g / 2
        sts_u32(dst + r0 * 64, u0);
        sts_u32(dst + (r0 + 8) * 64, u1);
      }
    }
    fence_proxy_async();  // the stores above, seen by wgmma
    named_sync(BAR_KV_READY, 2 * 128);

    // S = Q K^T over this warpgroup's 64 queries and the 128 keys
    float sf[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sf[i] = 0.0f;
    wgmma_fence();
    if constexpr (HD == 64) {
      const uint64_t dk = desc_sw128(k_tile, false);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs_n128(sf, qa[kk], dk + 2 * kk, kk > 0);
    } else {  // k-steps of 16 columns: two a 64-byte panel row, 32 bytes apart
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_n128(sf, qa[kk], desc_sw64(k_tile + (kk >> 1) * L::KV_PANEL) + 2 * (kk & 1),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sf);
    fence_regs(qa);

    // the softmax of rows r0 (elements with (i >> 1) & 1 == 0) and r0 + 8;
    // a row's values sit in the four threads of a quad
    float off0 = c_off, off1 = c_off;
    if (!st) {  // the row max (the scale > 0 commutes with it)
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        m0 = fmaxf(m0, fmaxf(sf[i], sf[i + 1]));
        m1 = fmaxf(m1, fmaxf(sf[i + 2], sf[i + 3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      off0 = -m0 * c_scale;
      off1 = -m1 * c_scale;
    }
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const bool hi = (i >> 1) & 1;
      float x = fmaf(sf[i], c_scale, hi ? off1 : off0);
      if (st) x = fminf(x, kClip);
      sf[i] = ex2(x);
      if (hi)
        l1 += sf[i];
      else
        l0 += sf[i];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    if (st) {
      l0 = fmaxf(l0, 1e-30f);
      l1 = fmaxf(l1, 1e-30f);
    }
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    // p / l in f32, then bf16: the A fragments of P V, keys 16 kk .. 16 kk + 15
    unsigned pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float inv = (e & 1) ? inv1 : inv0;
        pa[kk][e] = pack_bf16(sf[8 * kk + 2 * e] * inv, sf[8 * kk + 2 * e + 1] * inv);
      }

    // O = P V
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    wgmma_fence();
    if constexpr (HD == 64) {
      const uint64_t dv = desc_sw128(v_tile, true);
#pragma unroll
      for (int kk = 0; kk < AT / 16; ++kk) wgmma_rs<1>(o, pa[kk], dv + 128 * kk, kk > 0);
    } else {  // three 32-column panels (LBO); k-step of 16 keys: 16 rows of 64 bytes (64)
      const uint64_t dv = desc_sw64_mn(v_tile, L::KV_PANEL);
#pragma unroll
      for (int kk = 0; kk < AT / 16; ++kk) wgmma_rs_n96<1>(o, pa[kk], dv + 64 * kk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);

    if (p.a_av != nullptr) {
      // int8 codes, 16 bytes a thread: word m of a row holds columns
      // 16 m + 2 t, + 1, 16 m + 8 + 2 t, + 1; a transpose within the quad
      // gives thread t the words t of all four, columns 16 t .. 16 t + 15
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned w[4], u[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i0 = 8 * m + 2 * half, i1 = i0 + 4;  // groups 2 m and 2 m + 1
          w[m] = static_cast<uint8_t>(q8_rint(o[i0] * out_inv)) |
                 static_cast<unsigned>(static_cast<uint8_t>(q8_rint(o[i0 + 1] * out_inv))) << 8 |
                 static_cast<unsigned>(static_cast<uint8_t>(q8_rint(o[i1] * out_inv))) << 16 |
                 static_cast<unsigned>(static_cast<uint8_t>(q8_rint(o[i1 + 1] * out_inv))) << 24;
        }
        quad_transpose(w, u, lane, t);
        const uint4 out = make_uint4(__byte_perm(u[0], u[1], 0x5410), __byte_perm(u[2], u[3], 0x5410),
                                     __byte_perm(u[0], u[1], 0x7632), __byte_perm(u[2], u[3], 0x7632));
        *reinterpret_cast<uint4*>(p.av8 + (row0 + 8 * half) * p.D + h * HD + 16 * t) = out;
        if constexpr (HD == 96) {
          // columns 64 .. 95, 8 bytes a thread: word m holds group 8 + m's
          // pair (columns 64 + 8 m + 2 t, + 1); thread t gets group 8 + t
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i0 = 32 + 4 * m + 2 * half;
            w[m] = static_cast<uint8_t>(q8_rint(o[i0] * out_inv)) |
                   static_cast<unsigned>(static_cast<uint8_t>(q8_rint(o[i0 + 1] * out_inv))) << 8;
          }
          quad_transpose(w, u, lane, t);
          *reinterpret_cast<uint2*>(p.av8 + (row0 + 8 * half) * p.D + h * HD + 64 + 8 * t) =
              make_uint2(u[0] | u[1] << 16, u[2] | u[3] << 16);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < HD / 2; i += 2) {
        const long row = row0 + 8 * ((i >> 1) & 1);
        *reinterpret_cast<float2*>(p.avf + row * p.D + h * HD + 8 * (i >> 2) + 2 * t) =
            make_float2(o[i], o[i + 1]);
      }
    }
  }
}

// The launch plan's checks (the wrapper computes the plan: ops/kernels/
// fused_block.attn_block_plan): D = H heads of HD, K-steps of BK,
// 1 <= grid <= tiles (B H, one a (sample, head)).
template <int HD>
inline bool plan(int B, int H, int D, int grid, int smem_bytes, int& tiles) {
  if (B <= 0 || H <= 0 || D != H * HD || D % BK != 0) return false;
  const long all = static_cast<long>(B) * H;
  if (all > 2147483647L / AT) return false;
  tiles = static_cast<int>(all);
  return grid >= 1 && grid <= tiles && smem_bytes == Layout<HD>::SMEM;
}

template <int HD>
inline cudaError_t launch(const int8_t* q1, const int8_t* wqkv_t, int B, const Params& p,
                          int grid, int smem_bytes, cudaStream_t stream) {
  int tiles;
  if (!plan<HD>(B, p.H, p.D, grid, smem_bytes, tiles) || tiles != p.tiles)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[2];
  if (!kmajor_map(&maps[0], q1, B * AT, p.D, AT) || !kmajor_map(&maps[1], wqkv_t, 3 * p.D, p.D, HD))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<HD>::SMEM;
  const cudaError_t err =
      cudaFuncSetAttribute(attn_qkv_core_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_qkv_core_kernel<HD><<<grid, THREADS, smem, stream>>>(maps[0], maps[1], p);
  return cudaGetLastError();
}

}  // namespace qkvc

// bf16 core of any T (the split route) over the bf16 qkv (M, 3D): block =
// 64 query rows of one (sample, head), 4 warps of 16 rows; keys in chunks
// of 64, K (and V) by cp.async into rows padded to HD + 8 (the fragment
// loads of 8 rows hit distinct banks), zero past T. Pass 1: S = Q K^T
// (mma m16n8k16, q's A fragments in registers), the running row max and
// sum in units of log 2. Pass 2: S again, p = 2^(x - max) / sum in f32,
// rounded to bf16 (the A fragments of P V), V's B fragments by
// ldmatrix.trans. Keys past T score -inf (a zero-filled key row would
// otherwise count), query rows past T are not stored.
namespace core16 {

constexpr int BQ = 64, BKEYS = 64, THREADS = 128;

template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;               // a key row in shared memory, bf16
  static constexpr int SMEM = 2 * BKEYS * LD * 2;  // K and V chunks
};

struct Params {
  const __nv_bfloat16* qkv;  // (B T, 3 D)
  const float* smax;
  const float* a_av;
  int8_t* av8;
  float* avf;
  int T, H, D, nq;
  float scale;
};

__device__ __forceinline__ unsigned ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    attn_core_bf16_kernel(const Params p) {
  using L = Layout<HD>;
  constexpr int LD = L::LD, KS = HD / 16, NO = HD / 8, CH = HD / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[BKEYS * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BKEYS * LD];
  const int tile = blockIdx.x;
  const int qt = tile % p.nq, bh = tile / p.nq;
  const int h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long ld = 3L * p.D;
  const __nv_bfloat16* qg = p.qkv + static_cast<long>(b) * p.T * ld + h * HD;
  const __nv_bfloat16* kg = qg + p.D;
  const __nv_bfloat16* vg = qg + 2 * p.D;
  const int q0 = qt * BQ + 16 * warp + g, q1 = q0 + 8;  // this thread's query rows

  // q's A fragments, k-step kk: columns 16 kk + 2 t (+ 8); rows past T zero
  unsigned qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int col = 16 * kk + 2 * t;
    qa[kk][0] = q0 < p.T ? ld_b32(qg + q0 * ld + col) : 0u;
    qa[kk][1] = q1 < p.T ? ld_b32(qg + q1 * ld + col) : 0u;
    qa[kk][2] = q0 < p.T ? ld_b32(qg + q0 * ld + col + 8) : 0u;
    qa[kk][3] = q1 < p.T ? ld_b32(qg + q1 * ld + col + 8) : 0u;
  }
  const bool st = p.smax != nullptr;
  const float c_scale = p.scale * kLog2e;  // raw score -> units of log 2
  const float c_off = st ? -__ldg(p.smax) * kLog2e : 0.0f;
  constexpr float kClip = 20.0f * kLog2e;
  const int nk = (p.T + BKEYS - 1) / BKEYS;

  // keys k0 .. k0 + 63 of K (and V) into shared memory, zero past T
  auto load = [&](int k0, bool with_v) {
    __syncthreads();  // the last chunk is read
    for (int i = tid; i < BKEYS * CH; i += THREADS) {
      const int r = i / CH, ch = i - r * CH;
      const bool ok = k0 + r < p.T;
      const long src = static_cast<long>(ok ? k0 + r : 0) * ld + 8 * ch;
      cp_async16(ks + r * LD + 8 * ch, kg + src, ok);
      if (with_v) cp_async16(vs + r * LD + 8 * ch, vg + src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };
  // raw scores of the chunk: s[nb] = rows g, g + 8 x keys 8 nb + 2 t, + 1
  auto scores = [&](float (&s)[8][4]) {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const __nv_bfloat16* kr = ks + (8 * nb + g) * LD + 16 * kk + 2 * t;
        const unsigned bk[2] = {ld_b32(kr), ld_b32(kr + 8)};
        mma_bf16(s[nb], qa[kk], bk);
      }
  };

  // pass 1: the row max (safe softmax) and the sum, per thread over its
  // keys, rescaled as the max grows; the quad's partial sums added at the end
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  for (int kc = 0; kc < nk; ++kc) {
    const int k0 = kc * BKEYS;
    load(k0, false);
    float s[8][4];
    scores(s);
    if (!st) {
      float n0 = m0, n1 = m1;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * nb + 2 * t + (e & 1) < p.T) {
            if (e < 2)
              n0 = fmaxf(n0, s[nb][e]);
            else
              n1 = fmaxf(n1, s[nb][e]);
          }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, o));
        n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, o));
      }
      // chunk 0 holds key 0: n0 and n1 are finite from there on
      l0 *= ex2((m0 - n0) * c_scale);
      l1 *= ex2((m1 - n1) * c_scale);
      m0 = n0;
      m1 = n1;
    }
    const float off0 = st ? c_off : -m0 * c_scale, off1 = st ? c_off : -m1 * c_scale;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * nb + 2 * t + (e & 1) < p.T) {
          float x = fmaf(s[nb][e], c_scale, e < 2 ? off0 : off1);
          if (st) x = fminf(x, kClip);
          if (e < 2)
            l0 += ex2(x);
          else
            l1 += ex2(x);
        }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  if (st) {
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
  }
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const float off0 = st ? c_off : -m0 * c_scale, off1 = st ? c_off : -m1 * c_scale;

  // pass 2: p / l in f32, then bf16, and O += P V
  float o[NO][4];
#pragma unroll
  for (int dn = 0; dn < NO; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  for (int kc = 0; kc < nk; ++kc) {
    const int k0 = kc * BKEYS;
    load(k0, true);
    float s[8][4];
    scores(s);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[nb][e], c_scale, e < 2 ? off0 : off1);
        if (st) x = fminf(x, kClip);
        const bool ok = k0 + 8 * nb + 2 * t + (e & 1) < p.T;
        s[nb][e] = ok ? ex2(x) * (e < 2 ? inv0 : inv1) : 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < BKEYS / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < NO; dn += 2) {
        // matrices: keys 16 kk + (0..7 | 8..15) x columns 8 dn (+ 8)
        unsigned r[4];
        ldmatrix_x4_trans(r, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * dn +
                                 (lane >> 4) * 8);
        mma_bf16(o[dn], pa, r);
        mma_bf16(o[dn + 1], pa, r + 2);
      }
    }
  }

  const float out_inv = p.a_av != nullptr ? 1.0f / static_scale(p.a_av) : 0.0f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? q1 : q0;
    if (row >= p.T) continue;
    const long at = (static_cast<long>(b) * p.T + row) * p.D + h * HD + 2 * t;
#pragma unroll
    for (int dn = 0; dn < NO; ++dn) {
      const float v0 = o[dn][2 * half], v1 = o[dn][2 * half + 1];
      if (p.a_av != nullptr) {
        char2 q;
        q.x = q8_rint(v0 * out_inv);
        q.y = q8_rint(v1 * out_inv);
        *reinterpret_cast<char2*>(p.av8 + at + 8 * dn) = q;
      } else {
        *reinterpret_cast<float2*>(p.avf + at + 8 * dn) = make_float2(v0, v1);
      }
    }
  }
}

// The launch plan's checks: one block a (64 query rows, head, sample),
// the grid in one dimension, the static shared memory of head dim HD.
template <int HD>
inline bool plan(int B, int T, int H, int grid, int smem_bytes, int& nq) {
  if (B <= 0 || T <= 0 || H <= 0) return false;
  nq = (T + BQ - 1) / BQ;
  const long all = static_cast<long>(B) * H * nq;
  return all <= 2147483647L && grid == all && smem_bytes == Layout<HD>::SMEM;
}

template <int HD>
inline cudaError_t launch(const Params& p, int grid, cudaStream_t stream) {
  attn_core_bf16_kernel<HD><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace core16

// f32 and int8 cores: block (head, sample), one thread per query row (a
// block of T threads); K and V rows of the int8 core quantized into
// dynamic shared memory. Off the flagship path (core="bf16"); written for
// exactness, not speed.
constexpr int kScalarMaxT = 608;  // the most tokens the fused rule admits is 607 (D = 768)

template <int CORE, int HD>
__global__ void __launch_bounds__(kScalarMaxT)
    attn_core_scalar_kernel(const float* __restrict__ qkv, int T, int D, float scale,
                            const float* smax, const float* a_av, int8_t* av8, float* avf) {
  extern __shared__ __align__(16) unsigned char scalar_smem[];
  int8_t* k8 = reinterpret_cast<int8_t*>(scalar_smem);  // (T, HD), then v8
  int8_t* v8 = k8 + T * HD;
  float* sk = reinterpret_cast<float*>(v8 + T * HD);    // (T,), then sv
  float* sv = sk + T;
  const int h = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const long ld = 3L * D;
  const float* base = qkv + static_cast<long>(b) * T * ld + h * HD;
  const float* Kg = base + D;
  const float* Vg = base + 2 * D;

  float q[HD];
  int qi[HD];
  float sq = 1.0f;
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = base[i * ld + d];
  if (CORE == CORE_INT8) {
    // per-row quant of q*scale (query i), and of k and v rows (key i)
    float am = 0.0f, amk = 0.0f, amv = 0.0f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = q[d] * scale;
      am = fmaxf(am, fabsf(q[d]));
      amk = fmaxf(amk, fabsf(Kg[i * ld + d]));
      amv = fmaxf(amv, fabsf(Vg[i * ld + d]));
    }
    sq = fmaxf(am / 127.0f, 1e-8f);
    const float ssk = fmaxf(amk / 127.0f, 1e-8f), ssv = fmaxf(amv / 127.0f, 1e-8f);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qi[d] = q8_rint(q[d] / sq);
      k8[i * HD + d] = q8_rint(Kg[i * ld + d] / ssk);
      v8[i * HD + d] = q8_rint(Vg[i * ld + d] / ssv);
    }
    sk[i] = ssk;
    sv[i] = ssv;
    __syncthreads();
  }
  auto logit = [&](int j) -> float {
    if (CORE == CORE_INT8) {
      int acc = 0;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc += qi[d] * static_cast<int>(k8[j * HD + d]);
      return static_cast<float>(acc) * sq * sk[j];
    }
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc += q[d] * Kg[j * ld + d];
    return acc * scale;
  };
  const bool st = smax != nullptr;
  const float sm = st ? __ldg(smax) : 0.0f;
  float m = 0.0f;
  if (!st) {
    m = -INFINITY;
    for (int j = 0; j < T; ++j) m = fmaxf(m, logit(j));
  }
  auto ex = [&](float sv_) { return st ? expf(fminf(sv_ - sm, 20.0f)) : expf(sv_ - m); };
  float sum = 0.0f;
  for (int j = 0; j < T; ++j) sum += ex(logit(j));
  const float den = st ? fmaxf(sum, 1e-30f) : sum;

  float o[HD];
  if (CORE == CORE_INT8) {
    float pm = 0.0f;
    for (int j = 0; j < T; ++j) pm = fmaxf(pm, fabsf(ex(logit(j)) / den * sv[j]));
    const float sp = fmaxf(pm / 127.0f, 1e-8f);
    int oi[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) oi[d] = 0;
    for (int j = 0; j < T; ++j) {
      const int pq = q8_rint(ex(logit(j)) / den * sv[j] / sp);
#pragma unroll
      for (int d = 0; d < HD; ++d) oi[d] += pq * static_cast<int>(v8[j * HD + d]);
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = static_cast<float>(oi[d]) * sp;
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = 0.0f;
    for (int j = 0; j < T; ++j) {
      const float p = ex(logit(j)) / den;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] += p * Vg[j * ld + d];
    }
  }
  const long row = static_cast<long>(b) * T + i;
#pragma unroll
  for (int d = 0; d < HD; ++d) store_av(o[d], row * D + h * HD + d, a_av, av8, avf);
}

// The scalar cores' plan: a block of T threads a (head, sample), the int8
// core's K and V codes and row scales in dynamic shared memory.
inline bool scalar_plan(int B, int T, int H, int HD, int core, int grid, int smem_bytes) {
  if (B <= 0 || T <= 0 || T > kScalarMaxT || H <= 0) return false;
  const int want = core == CORE_INT8 ? 2 * T * HD + 8 * T : 0;
  return static_cast<long>(B) * H == grid && smem_bytes == want && smem_bytes <= 232448;
}

template <int CORE, int HD>
inline cudaError_t launch_scalar(const float* qkv, int B, int T, int D, int H, float scale,
                                 const float* smax, const float* a_av, int8_t* av8, float* avf,
                                 int smem_bytes, cudaStream_t stream) {
  auto kernel = attn_core_scalar_kernel<CORE, HD>;
  if (smem_bytes > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(H, B), T, smem_bytes, stream>>>(qkv, T, D, scale, smax, a_av, av8, avf);
  return cudaGetLastError();
}

}  // namespace nova

extern "C" int nova_fused_attention_block(
    const void* x, int x_bf16, int B, int T, int D, int H,
    const void* ln_w, const void* ln_b, const void* bqkv, const void* bo, int vec_bf16,
    const int8_t* wqkv_t, const float* sqkv, const int8_t* wo_t, const float* so,
    const float* a_in, const float* a_av, const float* a_smax, int core, float scale,
    int8_t* q1, float* sx1, void* qkv, int8_t* av8, float* avf, float* sxo,
    void* y, int grid_core, int smem_core, int grid_qkv, int block_qkv, int smem_qkv,
    int grid_out, int smem_out, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0 || core < CORE_F32 || core > CORE_INT8)
    return cudaErrorInvalidValue;
  const int M = B * T, hd = D / H;
  if (hd != 64 && hd != 96) return cudaErrorInvalidValue;
  // the bf16 core: one kernel at T = AT, else the split route; the f32 and
  // int8 cores: the scalar kernel
  const bool static_acts = a_in != nullptr, fused = core == CORE_BF16 && T == AT,
             split = core == CORE_BF16 && T != AT;
  if (static_acts != (a_av != nullptr)) return cudaErrorInvalidValue;
  if ((!static_acts && avf == nullptr) || (!fused && qkv == nullptr)) return cudaErrorInvalidValue;
  int tiles = 0, nq = 0, n_tiles, gemm_tiles;
  const bool core_ok =
      fused ? (hd == 64 ? qkvc::plan<64>(B, H, D, grid_core, smem_core, tiles)
                        : qkvc::plan<96>(B, H, D, grid_core, smem_core, tiles))
      : split ? (hd == 64 ? core16::plan<64>(B, T, H, grid_core, smem_core, nq)
                          : core16::plan<96>(B, T, H, grid_core, smem_core, nq)) &&
                    wg8::plan_store(block_qkv, 1, M, 3 * D, D, grid_qkv, smem_qkv)
              : scalar_plan(B, T, H, hd, core, grid_core, smem_core) &&
                    wg8::plan_store(block_qkv, 0, M, 3 * D, D, grid_qkv, smem_qkv);
  if (!core_ok || !wg8::plan(M, D, D, grid_out, smem_out, n_tiles, gemm_tiles))
    return cudaErrorInvalidConfiguration;

  cudaError_t err = launch_row_quant(x, x_bf16, M, D, ln_w, ln_b, vec_bf16, a_in, q1, sx1,
                                     stream);
  if (err != cudaSuccess) return err;

  if (fused) {
    qkvc::Params p = {};
    p.sx = sx1;
    p.w_scale = sqkv;
    p.bias = bqkv;
    p.bias_bf16 = vec_bf16;
    p.smax = a_smax;
    p.a_av = a_av;
    p.av8 = av8;
    p.avf = avf;
    p.H = H;
    p.D = D;
    p.tiles = tiles;
    p.ktiles = D / qkvc::BK;
    p.scale = scale;
    err = hd == 64 ? qkvc::launch<64>(q1, wqkv_t, B, p, grid_core, smem_core, stream)
                   : qkvc::launch<96>(q1, wqkv_t, B, p, grid_core, smem_core, stream);
    if (err != cudaSuccess) return err;
  } else {
    // q|k|v = the GEMM's EPI_STORE: bf16 (split) or f32 (scalar cores)
    EpiParams e1 = {};
    e1.sx_rows = sx1;
    e1.w_scale = sqkv;
    e1.bias = bqkv;
    e1.bias_bf16 = vec_bf16;
    e1.out = qkv;
    e1.out_bf16 = split ? 1 : 0;
    err = wg8::launch_store<EPI_STORE>(block_qkv, split ? 1 : 0, q1, wqkv_t, M, 3 * D, D, e1,
                                       grid_qkv, smem_qkv, stream);
    if (err != cudaSuccess) return err;
    if (split) {
      core16::Params p = {};
      p.qkv = static_cast<const __nv_bfloat16*>(qkv);
      p.smax = a_smax;
      p.a_av = a_av;
      p.av8 = av8;
      p.avf = avf;
      p.T = T;
      p.H = H;
      p.D = D;
      p.nq = nq;
      p.scale = scale;
      err = hd == 64 ? core16::launch<64>(p, grid_core, stream)
                     : core16::launch<96>(p, grid_core, stream);
    } else {
      const float* qf = static_cast<const float*>(qkv);
      if (core == CORE_F32)
        err = hd == 64 ? launch_scalar<CORE_F32, 64>(qf, B, T, D, H, scale, a_smax, a_av, av8,
                                                      avf, smem_core, stream)
                       : launch_scalar<CORE_F32, 96>(qf, B, T, D, H, scale, a_smax, a_av, av8,
                                                      avf, smem_core, stream);
      else
        err = hd == 64 ? launch_scalar<CORE_INT8, 64>(qf, B, T, D, H, scale, a_smax, a_av, av8,
                                                       avf, smem_core, stream)
                       : launch_scalar<CORE_INT8, 96>(qf, B, T, D, H, scale, a_smax, a_av, av8,
                                                       avf, smem_core, stream);
    }
    if (err != cudaSuccess) return err;
  }
  if (!static_acts) {
    err = launch_row_quant(avf, 0, M, D, nullptr, nullptr, 0, nullptr, av8, sxo, stream);
    if (err != cudaSuccess) return err;
  }

  EpiParams e2 = {};
  e2.sx_rows = static_acts ? nullptr : sxo;
  e2.sx_amax = a_av;
  e2.w_scale = so;
  e2.bias = bo;
  e2.bias_bf16 = vec_bf16;
  e2.resid = x;
  e2.resid_bf16 = x_bf16;
  e2.out = y;
  e2.out_bf16 = x_bf16;
  return wg8::launch<EPI_RESIDUAL>(av8, wo_t, M, D, D, e2, grid_out, smem_out, stream);
}
