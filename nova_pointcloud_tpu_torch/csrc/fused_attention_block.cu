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
// K-major: wqkv_t (3D, D) and wo_t (D, D) row-major.
//
// What bounds it on this card: the int8 projections, 2*M*D*4D operations,
// plus the bf16 core, 4*B*T^2*D FLOPs (0.156 ms together at B=256, T=128,
// D=1024 against the int8 and bf16 peaks); the bytes are under half of
// that once q, k and v stay on chip. Design for the bf16 core (the
// flagship's), three launches:
//   (1) one block per row does LN + quant;
//   (2) attn_qkv_core_kernel: the QKV product and the attention core of one
//       (sample, head) tile in one persistent kernel, so the M x 3D qkv
//       tensor never reaches device memory. A producer warp streams the
//       sample's 128 int8 rows and the head's 192 weight rows (three
//       64-row boxes of wqkv_t: q, k and v) by TMA through a ring; two
//       consumer warpgroups of 64 rows run s8 wgmma at n = 192. The
//       epilogue dequantizes exactly as the GEMM's EPI_STORE does and rounds
//       to bf16: q stays in registers as the A fragments of S = Q K^T (the
//       accumulator's column pairs are the bf16 A-fragment layout), k and v
//       go to shared memory in the 128B-swizzled layout of the wgmma
//       descriptors. S runs as wgmma m64n128k16, P V as m64n64k16 with P
//       from registers and V as a transposed operand; the softmax in
//       between in registers (scores in units of log 2, p normalized in f32
//       before its bf16 rounding). The output is quantized with the static
//       a_av and stored 16 bytes a thread (a transpose within each quad),
//       or on the per-row path written in f32 for (2b) a row pass, which
//       needs the whole D-wide row. The producer loads the next tile while
//       the consumers run the core; tiles walk with the head fastest, so
//       the blocks running together share the sample's rows in L2 and
//       wqkv_t (3 MB) stays there;
//   (3) the out-projection on the wgmma GEMM (int8_wgmma.cuh), whose
//       epilogue adds bo and the residual.
// The f32 and int8 cores (off the flagship path) run the QKV product on the
// same GEMM writing f32 qkv, one thread per query row in the core, and the
// same out-projection.

#include "int8_wgmma.cuh"

namespace nova {

constexpr int AT = 128;   // tokens per sample the core handles
constexpr int AHD = 64;   // head dim the core handles
enum { CORE_F32 = 0, CORE_BF16 = 1, CORE_INT8 = 2 };

__device__ __forceinline__ void store_av(float v, long idx, const float* a_av, int8_t* av8,
                                         float* avf) {
  if (a_av != nullptr)
    av8[idx] = q8_rint(v * (1.0f / static_scale(a_av)));
  else
    avf[idx] = v;
}

namespace qkvc {

constexpr int BN = 3 * AHD;  // the head's q, k and v columns
constexpr int BK = 128, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int A_BYTES = AT * BK;                // 16 KB: the sample's rows
constexpr int W_BOX = AHD * BK;                 // 8 KB: 64 weight rows
constexpr int STAGE_BYTES = A_BYTES + 3 * W_BOX;
constexpr int KV_BYTES = AT * AHD * 2;          // K or V, bf16
constexpr int OFF_K = STAGES * STAGE_BYTES;
constexpr int OFF_V = OFF_K + KV_BYTES;
constexpr int OFF_BAR = OFF_V + KV_BYTES;       // full[s], then empty[s]
constexpr int OFF_EPI = OFF_BAR + 2 * STAGES * 8;
constexpr int EPI_BYTES = 2 * BN * 4;           // a consumer's column scales and biases
constexpr int SMEM = OFF_EPI + CONSUMERS * EPI_BYTES + 1024;  // + 1024 to align the tiles
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BAR_KV_FREE = 1, BAR_KV_READY = 2;  // named barriers of both consumers
constexpr float kLog2e = 1.4426950408889634f;

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

__global__ void __launch_bounds__(THREADS, 1)
    attn_qkv_core_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warp-uniform
  const uint32_t full = base + OFF_BAR, empty = full + STAGES * 8;
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
          for (int i = 0; i < 3; ++i)  // rows h 64, D + h 64, 2 D + h 64: q, k, v
            tma_load_2d(dst + A_BYTES + i * W_BOX, &tm_w, bar, kt * BK, i * p.D + h * AHD);
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
  const uint32_t s_ws = base + OFF_EPI + c * EPI_BYTES, s_bs = s_ws + BN * 4;
  const uint32_t k_tile = base + OFF_K, v_tile = base + OFF_V;
  const bool st = p.smax != nullptr;
  const float c_scale = p.scale * kLog2e;  // raw score -> units of log 2
  const float c_off = st ? -__ldg(p.smax) * kLog2e : 0.0f;
  constexpr float kClip = 20.0f * kLog2e;
  const float out_inv = p.a_av != nullptr ? 1.0f / static_scale(p.a_av) : 0.0f;
  int s = 0;
  uint32_t phase = 0;
  int acc[96];
  // the four k-steps of 32 bytes of the stage in slot `slot`
  auto issue = [&](int slot, bool first) {
    const uint64_t da = desc_sw128(base + slot * STAGE_BYTES + c * 64 * BK, false);
    const uint64_t dw = desc_sw128(base + slot * STAGE_BYTES + A_BYTES, false);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      wgmma_s8_n192(acc, da + 2 * kk, dw + 2 * kk, !first || kk > 0);
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

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int b = tile / p.H, h = tile - b * p.H;
    // accumulator / score / output element i of this thread: row (query
    // or key) r0 + 8 ((i >> 1) & 1) of the sample, column 8 (i >> 2) +
    // 2 t + (i & 1); r0 & 7 == g
    const int r0 = 64 * c + 16 * warp + g;
    const long row0 = static_cast<long>(b) * AT + r0;
    // what the epilogue reads, loaded while the products run: the scales
    // and biases of columns lt and 128 + lt (lt < 64) of the tile's 192,
    // and the two rows' activation scales
    float my_ws[2] = {0.0f, 0.0f}, my_bs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int cc = lt + 128 * hh;
      if (cc < BN) {
        const int col = (cc >> 6) * p.D + h * AHD + (cc & 63);
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

    // this warpgroup's earlier reads of the staged columns ended before the
    // last tile's BAR_KV_READY; after BAR_KV_FREE both consumers' last P V
    // products are done with K and V
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (lt + 128 * hh < BN) {
        sts_u32(s_ws + 4 * (lt + 128 * hh), __float_as_uint(my_ws[hh]));
        sts_u32(s_bs + 4 * (lt + 128 * hh), __float_as_uint(my_bs[hh]));
      }
    named_sync(BAR_KV_FREE, 2 * 128);

    // q, k, v = acc * sx * w_scale + bias, rounded to bf16 (the GEMM's
    // EPI_STORE with a bf16 output): q into the A fragments of S (k-step kk
    // holds column groups 2 kk and 2 kk + 1), k and v into shared memory,
    // row = key, 128 bytes a row, 16-byte chunk j at j ^ (key & 7)
    unsigned qa[4][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 w2 = lds_f2(s_ws + 4 * col), b2 = lds_f2(s_bs + 4 * col);
      const float v00 = static_cast<float>(acc[4 * j]) * sx0 * w2.x + b2.x;
      const float v01 = static_cast<float>(acc[4 * j + 1]) * sx0 * w2.y + b2.y;
      const float v10 = static_cast<float>(acc[4 * j + 2]) * sx1 * w2.x + b2.x;
      const float v11 = static_cast<float>(acc[4 * j + 3]) * sx1 * w2.y + b2.y;
      const unsigned u0 = pack_bf16(v00, v01), u1 = pack_bf16(v10, v11);
      if (j < 8) {
        qa[j >> 1][2 * (j & 1)] = u0;
        qa[j >> 1][2 * (j & 1) + 1] = u1;
      } else {
        const uint32_t dst = (j < 16 ? k_tile : v_tile) + (((j & 7) ^ g) << 4) + 4 * t;
        sts_u32(dst + r0 * 128, u0);
        sts_u32(dst + (r0 + 8) * 128, u1);
      }
    }
    fence_proxy_async();  // the stores above, seen by wgmma
    named_sync(BAR_KV_READY, 2 * 128);

    // S = Q K^T over this warpgroup's 64 queries and the 128 keys
    float sf[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sf[i] = 0.0f;
    wgmma_fence();
    const uint64_t dk = desc_sw128(k_tile, false);
#pragma unroll
    for (int kk = 0; kk < AHD / 16; ++kk) wgmma_rs_n128(sf, qa[kk], dk + 2 * kk, kk > 0);
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
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    wgmma_fence();
    const uint64_t dv = desc_sw128(v_tile, true);
#pragma unroll
    for (int kk = 0; kk < AT / 16; ++kk) wgmma_rs<1>(o, pa[kk], dv + 128 * kk, kk > 0);
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
        unsigned w[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i0 = 8 * m + 2 * half, i1 = i0 + 4;  // groups 2 m and 2 m + 1
          w[m] = static_cast<uint8_t>(q8_rint(o[i0] * out_inv)) |
                 static_cast<unsigned>(static_cast<uint8_t>(q8_rint(o[i0 + 1] * out_inv))) << 8 |
                 static_cast<unsigned>(static_cast<uint8_t>(q8_rint(o[i1] * out_inv))) << 16 |
                 static_cast<unsigned>(static_cast<uint8_t>(q8_rint(o[i1 + 1] * out_inv))) << 24;
        }
        unsigned rcv[4], u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)  // from thread (t + r) & 3: its word t
          rcv[r] = __shfl_sync(0xffffffffu, pick4(w, (t - r) & 3), (lane & ~3) | ((t + r) & 3));
#pragma unroll
        for (int k = 0; k < 4; ++k) u[k] = pick4(rcv, (k - t) & 3);  // thread k's word t
        const uint4 out = make_uint4(__byte_perm(u[0], u[1], 0x5410), __byte_perm(u[2], u[3], 0x5410),
                                     __byte_perm(u[0], u[1], 0x7632), __byte_perm(u[2], u[3], 0x7632));
        *reinterpret_cast<uint4*>(p.av8 + (row0 + 8 * half) * p.D + h * AHD + 16 * t) = out;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const long row = row0 + 8 * ((i >> 1) & 1);
        *reinterpret_cast<float2*>(p.avf + row * p.D + h * AHD + 8 * (i >> 2) + 2 * t) =
            make_float2(o[i], o[i + 1]);
      }
    }
  }
}

// The launch plan's checks (the wrapper computes the plan: ops/kernels/
// fused_block.attn_block_plan): D = H heads of AHD, K-steps of BK,
// 1 <= grid <= tiles (B H, one a (sample, head)).
inline bool plan(int B, int H, int D, int grid, int smem_bytes, int& tiles) {
  if (B <= 0 || H <= 0 || D != H * AHD || D % BK != 0) return false;
  const long all = static_cast<long>(B) * H;
  if (all > 2147483647L / AT) return false;
  tiles = static_cast<int>(all);
  return grid >= 1 && grid <= tiles && smem_bytes == SMEM;
}

inline cudaError_t launch(const int8_t* q1, const int8_t* wqkv_t, int B, const Params& p,
                          int grid, int smem_bytes, cudaStream_t stream) {
  int tiles;
  if (!plan(B, p.H, p.D, grid, smem_bytes, tiles) || tiles != p.tiles)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[2];
  if (!kmajor_map(&maps[0], q1, B * AT, p.D, AT) || !kmajor_map(&maps[1], wqkv_t, 3 * p.D, p.D, AHD))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(attn_qkv_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  attn_qkv_core_kernel<<<grid, THREADS, SMEM, stream>>>(maps[0], maps[1], p);
  return cudaGetLastError();
}

}  // namespace qkvc

// f32 and int8 cores: block (head, sample), one thread per query row.
// Off the flagship path (core="bf16"); written for exactness, not speed.
template <int CORE>
__global__ void __launch_bounds__(AT)
    attn_core_scalar_kernel(const float* __restrict__ qkv, int D, float scale,
                            const float* smax, const float* a_av, int8_t* av8, float* avf) {
  __shared__ int8_t k8[AT][AHD];
  __shared__ int8_t v8[AT][AHD];
  __shared__ float sk[AT], sv[AT];
  const int h = blockIdx.x, b = blockIdx.y, i = threadIdx.x;
  const long ld = 3L * D;
  const float* base = qkv + static_cast<long>(b) * AT * ld + h * AHD;
  const float* Kg = base + D;
  const float* Vg = base + 2 * D;

  float q[AHD];
  int qi[AHD];
  float sq = 1.0f;
#pragma unroll
  for (int d = 0; d < AHD; ++d) q[d] = base[i * ld + d];
  if (CORE == CORE_INT8) {
    // per-row quant of q*scale (query i), and of k and v rows (key i)
    float am = 0.0f, amk = 0.0f, amv = 0.0f;
#pragma unroll
    for (int d = 0; d < AHD; ++d) {
      q[d] = q[d] * scale;
      am = fmaxf(am, fabsf(q[d]));
      amk = fmaxf(amk, fabsf(Kg[i * ld + d]));
      amv = fmaxf(amv, fabsf(Vg[i * ld + d]));
    }
    sq = fmaxf(am / 127.0f, 1e-8f);
    const float ssk = fmaxf(amk / 127.0f, 1e-8f), ssv = fmaxf(amv / 127.0f, 1e-8f);
#pragma unroll
    for (int d = 0; d < AHD; ++d) {
      qi[d] = q8_rint(q[d] / sq);
      k8[i][d] = q8_rint(Kg[i * ld + d] / ssk);
      v8[i][d] = q8_rint(Vg[i * ld + d] / ssv);
    }
    sk[i] = ssk;
    sv[i] = ssv;
    __syncthreads();
  }
  auto logit = [&](int j) -> float {
    if (CORE == CORE_INT8) {
      int acc = 0;
#pragma unroll
      for (int d = 0; d < AHD; ++d) acc += qi[d] * static_cast<int>(k8[j][d]);
      return static_cast<float>(acc) * sq * sk[j];
    }
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < AHD; ++d) acc += q[d] * Kg[j * ld + d];
    return acc * scale;
  };
  const bool st = smax != nullptr;
  const float sm = st ? __ldg(smax) : 0.0f;
  float m = 0.0f;
  if (!st) {
    m = -INFINITY;
    for (int j = 0; j < AT; ++j) m = fmaxf(m, logit(j));
  }
  auto ex = [&](float sv_) { return st ? expf(fminf(sv_ - sm, 20.0f)) : expf(sv_ - m); };
  float sum = 0.0f;
  for (int j = 0; j < AT; ++j) sum += ex(logit(j));
  const float den = st ? fmaxf(sum, 1e-30f) : sum;

  float o[AHD];
  if (CORE == CORE_INT8) {
    float pm = 0.0f;
    for (int j = 0; j < AT; ++j) pm = fmaxf(pm, fabsf(ex(logit(j)) / den * sv[j]));
    const float sp = fmaxf(pm / 127.0f, 1e-8f);
    int oi[AHD];
#pragma unroll
    for (int d = 0; d < AHD; ++d) oi[d] = 0;
    for (int j = 0; j < AT; ++j) {
      const int pq = q8_rint(ex(logit(j)) / den * sv[j] / sp);
#pragma unroll
      for (int d = 0; d < AHD; ++d) oi[d] += pq * static_cast<int>(v8[j][d]);
    }
#pragma unroll
    for (int d = 0; d < AHD; ++d) o[d] = static_cast<float>(oi[d]) * sp;
  } else {
#pragma unroll
    for (int d = 0; d < AHD; ++d) o[d] = 0.0f;
    for (int j = 0; j < AT; ++j) {
      const float p = ex(logit(j)) / den;
#pragma unroll
      for (int d = 0; d < AHD; ++d) o[d] += p * Vg[j * ld + d];
    }
  }
  const long row = static_cast<long>(b) * AT + i;
#pragma unroll
  for (int d = 0; d < AHD; ++d) store_av(o[d], row * D + h * AHD + d, a_av, av8, avf);
}

}  // namespace nova

extern "C" int nova_fused_attention_block(
    const void* x, int x_bf16, int B, int T, int D, int H,
    const void* ln_w, const void* ln_b, const void* bqkv, const void* bo, int vec_bf16,
    const int8_t* wqkv_t, const float* sqkv, const int8_t* wo_t, const float* so,
    const float* a_in, const float* a_av, const float* a_smax, int core, float scale,
    int8_t* q1, float* sx1, float* qkv, int8_t* av8, float* avf, float* sxo,
    void* y, int grid_core, int smem_core, int grid_qkv, int smem_qkv, int grid_out, int smem_out,
    void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * T;
  if (T != AT || D != H * AHD || core < CORE_F32 || core > CORE_INT8) return cudaErrorInvalidValue;
  const bool static_acts = a_in != nullptr, fused = core == CORE_BF16;
  if (static_acts != (a_av != nullptr)) return cudaErrorInvalidValue;
  if ((!static_acts && avf == nullptr) || (!fused && qkv == nullptr)) return cudaErrorInvalidValue;
  int tiles, n_tiles, gemm_tiles;
  if ((fused && !qkvc::plan(B, H, D, grid_core, smem_core, tiles)) ||
      (!fused && !wg8::plan(M, 3 * D, D, grid_qkv, smem_qkv, n_tiles, gemm_tiles)) ||
      !wg8::plan(M, D, D, grid_out, smem_out, n_tiles, gemm_tiles))
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
    err = qkvc::launch(q1, wqkv_t, B, p, grid_core, smem_core, stream);
    if (err != cudaSuccess) return err;
  } else {
    EpiParams e1 = {};
    e1.sx_rows = sx1;
    e1.w_scale = sqkv;
    e1.bias = bqkv;
    e1.bias_bf16 = vec_bf16;
    e1.out = qkv;
    e1.out_bf16 = 0;
    err = wg8::launch<EPI_STORE>(q1, wqkv_t, M, 3 * D, D, e1, grid_qkv, smem_qkv, stream);
    if (err != cudaSuccess) return err;
    const dim3 grid(H, B);
    if (core == CORE_F32)
      attn_core_scalar_kernel<CORE_F32><<<grid, AT, 0, stream>>>(qkv, D, scale, a_smax, a_av,
                                                                  av8, avf);
    else
      attn_core_scalar_kernel<CORE_INT8><<<grid, AT, 0, stream>>>(qkv, D, scale, a_smax, a_av,
                                                                   av8, avf);
    err = cudaGetLastError();
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
