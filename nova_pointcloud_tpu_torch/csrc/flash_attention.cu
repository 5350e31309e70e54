// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the forward Pallas TPU kernel of flash_attention
// (nova_pointcloud_tpu/ops/pallas/flash_attention.py, _fwd_kernel):
//
//   o   = softmax(q k^T / sqrt(d) + bias) v          in q's dtype
//   lse = m + log(l)                                 f32, (B*H, Lq)
//
// by online softmax over key tiles (running max m from -1e30, running sum
// l), f32 accumulation, so the (Lq, Lk) scores never reach device memory.
// bias: none, a key bias (B, Lk) read with the batch index bh / H (no per-head
// copies), or a full bias (Lq, Lk) shared by every (batch, head); -inf
// entries mask. A row whose keys are all masked by -inf gives o = 0 and
// lse = +1e30, as the TPU kernel. The backward kernels (dK/dV, dQ) read the
// saved lse; they are not in this file yet.
//
// q, k, v, o are (B, H, L, d) views given by their batch / head / row strides
// with d contiguous, so the model's (B, L, H, d) projections are read and
// written in place. Ragged tails are masked here: keys past Lk load as zeros
// and score -inf, query rows past Lq are computed and not stored.
//
// What bounds it on this card: operations. 4*B*H*Lq*Lk*d bf16 FLOPs (0.21 ms
// at B*H=192, L=2048, d=64 against the 989 TFLOP/s bf16 peak) against 0.2 GB
// of q, k, v, o (0.06 ms). Design: one block per (batch*head, 128-query
// tile), 8 warps of 16 query rows; the warp's q fragments stay in registers;
// K and V tiles of 64 keys stream through a double-buffered cp.async ring in
// shared memory; q k^T and p v run on tensor cores (mma.sync m16n8k16 bf16,
// f32 accumulators) with the softmax in registers between them, p rounded
// to bf16 as the second product's A fragments. Query tiles of one (batch,
// head) are neighbouring blocks, so its K and V stay in L2. f32 inputs take
// a SIMT path (one thread per query row), written for exactness, not speed.
// The bf16 path keeps scores in units of log 2 (one ex2 a probability), is
// built with fused multiply-add (it has no rounding identity to keep with a
// reference, unlike the int8 kernels) and is held to 128 registers so two
// blocks share an SM. A first design: no TMA, no wgmma.

#include "quant.cuh"
#include "tensor_core.cuh"

namespace nova {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 2^x by the special-function unit; ex2(-inf) = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // (B*H, Lq)
  const float* kbias;  // (B, Lk) or nullptr
  const float* fbias;  // (Lq, Lk) or nullptr
  long q_sb, q_sh, q_sl;  // strides in elements: batch, head, row
  long k_sb, k_sh, k_sl;
  long v_sb, v_sh, v_sl;
  long o_sb, o_sh, o_sl;
  int H, Lq, Lk;
  float scale;
};

constexpr int FBQ = 128;  // query rows per block (8 warps x 16)
constexpr int FBK = 64;   // keys per tile

template <int HD>
constexpr int flash_smem_bytes() {
  return 2 * 2 * FBK * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int HD>
__global__ void __launch_bounds__(256, 2) flash_fwd_bf16_kernel(FlashParams p) {
  constexpr int LD = HD + 8;  // padded smem row (bf16): conflict-free ldmatrix
  constexpr int KS = HD / 16;  // k-steps of q k^T
  constexpr int DT = HD / 8;   // n8 tiles of the output's head dim
  constexpr int CPR = HD / 8;  // 16-byte chunks per K / V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int nq = (p.Lq + FBQ - 1) / FBQ;
  const int qt = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int ntiles = (p.Lk + FBK - 1) / FBK;

  auto load_tile = [&](int buf, int kt) {
    __nv_bfloat16* Ks = smem + buf * 2 * FBK * LD;
    __nv_bfloat16* Vs = Ks + FBK * LD;
#pragma unroll
    for (int i = 0; i < FBK * CPR / 256; ++i) {
      const int c = tid + i * 256, r = c / CPR, col = (c % CPR) * 8;
      const int key = kt * FBK + r;
      const bool ok = key < p.Lk;
      const long kr = ok ? key : 0;
      cp_async16(Ks + r * LD + col, K + kr * p.k_sl + col, ok);
      cp_async16(Vs + r * LD + col, V + kr * p.v_sl + col, ok);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // this thread's two query rows (g and g + 8 of the warp's 16)
  const int row0 = qt * FBQ + warp * 16 + g, row1 = row0 + 8;
  const bool live0 = row0 < p.Lq, live1 = row1 < p.Lq;
  unsigned qa[KS][4];
  {
    const __nv_bfloat16* q0 = Q + static_cast<long>(live0 ? row0 : 0) * p.q_sl;
    const __nv_bfloat16* q1 = Q + static_cast<long>(live1 ? row1 : 0) * p.q_sl;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const unsigned a0 = *reinterpret_cast<const unsigned*>(q0 + ks * 16 + tig * 2);
      const unsigned a1 = *reinterpret_cast<const unsigned*>(q1 + ks * 16 + tig * 2);
      const unsigned a2 = *reinterpret_cast<const unsigned*>(q0 + ks * 16 + 8 + tig * 2);
      const unsigned a3 = *reinterpret_cast<const unsigned*>(q1 + ks * 16 + 8 + tig * 2);
      qa[ks][0] = live0 ? a0 : 0u;
      qa[ks][1] = live1 ? a1 : 0u;
      qa[ks][2] = live0 ? a2 : 0u;
      qa[ks][3] = live1 ? a3 : 0u;
    }
  }
  const float* kb = p.kbias != nullptr ? p.kbias + static_cast<long>(b) * p.Lk : nullptr;
  const float* fb0 =
      p.fbias != nullptr ? p.fbias + static_cast<long>(live0 ? row0 : 0) * p.Lk : nullptr;
  const float* fb1 =
      p.fbias != nullptr ? p.fbias + static_cast<long>(live1 ? row1 : 0) * p.Lk : nullptr;

  float o[DT][4];
#pragma unroll
  for (int nt = 0; nt < DT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.0f;
  // scores and the running maxima are kept in units of log 2 (times log2 e),
  // so each probability is one ex2 of one multiply-add
  const float scale2 = p.scale * kLog2e;
  float m0 = kNegInf * kLog2e, m1 = m0, l0 = 0.0f, l1 = 0.0f;  // l: this thread's share

  // ldmatrix lanes: K fragments (keys x d, d contiguous) for two n8 key
  // tiles; V fragments (keys x d, transposed on load) for two n8 d tiles
  const int k_key = (lane & 7) + (lane >> 4) * 8, k_d = ((lane >> 3) & 1) * 8;
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8, v_d = (lane >> 4) * 8;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; everyone is done with tile kt - 1
    if (kt + 1 < ntiles) load_tile((kt + 1) & 1, kt + 1);
    cp_async_commit();
    const __nv_bfloat16* Ks = smem + (kt & 1) * 2 * FBK * LD;
    const __nv_bfloat16* Vs = Ks + FBK * LD;

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        unsigned r[4];
        ldmatrix_x4(r, Ks + (nt * 8 + k_key) * LD + ks * 16 + k_d);
        mma_bf16(s[nt], qa[ks], r);
        mma_bf16(s[nt + 1], qa[ks], r + 2);
      }

    // the tile's row maxima, in units of log 2. A whole tile without a bias
    // keeps the raw scores (scale2 > 0: the max commutes) and folds the
    // scale into the exponent's multiply-add; else scale, biases, ragged tail
    const bool bare = kb == nullptr && fb0 == nullptr && (kt + 1) * FBK <= p.Lk;
    float t0 = -INFINITY, t1 = -INFINITY;
    if (bare) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        t0 = fmaxf(t0, fmaxf(s[nt][0], s[nt][1]));
        t1 = fmaxf(t1, fmaxf(s[nt][2], s[nt][3]));
      }
      t0 *= scale2;
      t1 *= scale2;
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = kt * FBK + nt * 8 + tig * 2 + c;
          float a = s[nt][c] * scale2, e = s[nt][2 + c] * scale2;
          if (key < p.Lk) {
            if (kb != nullptr) {
              const float kv = kb[key] * kLog2e;
              a += kv;
              e += kv;
            }
            if (fb0 != nullptr) {
              a += fb0[key] * kLog2e;
              e += fb1[key] * kLog2e;
            }
          } else {
            a = -INFINITY;
            e = -INFINITY;
          }
          s[nt][c] = a;
          s[nt][2 + c] = e;
          t0 = fmaxf(t0, a);
          t1 = fmaxf(t1, e);
        }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {  // a row's values sit in one quad
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, w));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, w));
    }
    const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);  // >= -1e30 log2 e: finite
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float mul = bare ? scale2 : 1.0f;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = ex2(s[nt][0] * mul - mn0);
      s[nt][1] = ex2(s[nt][1] * mul - mn0);
      s[nt][2] = ex2(s[nt][2] * mul - mn1);
      s[nt][3] = ex2(s[nt][3] * mul - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int nt = 0; nt < DT; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < FBK / 16; ++j) {  // keys 16j..16j+15: S's C fragments are P's A fragments
      const unsigned pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int nt = 0; nt < DT; nt += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Vs + (j * 16 + v_key) * LD + nt * 8 + v_d);
        mma_bf16(o[nt], pa, r);
        mma_bf16(o[nt + 1], pa, r + 2);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const bool dead0 = l0 == 0.0f, dead1 = l1 == 0.0f;  // every key masked by -inf
  const float d0 = dead0 ? 1.0f : l0, d1 = dead1 ? 1.0f : l1;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int nt = 0; nt < DT; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (live0)
      *reinterpret_cast<__nv_bfloat162*>(O + static_cast<long>(row0) * p.o_sl + col) =
          __floats2bfloat162_rn(o[nt][0] / d0, o[nt][1] / d0);
    if (live1)
      *reinterpret_cast<__nv_bfloat162*>(O + static_cast<long>(row1) * p.o_sl + col) =
          __floats2bfloat162_rn(o[nt][2] / d1, o[nt][3] / d1);
  }
  if (tig == 0) {
    float* lse = p.lse + static_cast<long>(bh) * p.Lq;
    if (live0) lse[row0] = dead0 ? -kNegInf : m0 * kLn2 + logf(l0);
    if (live1) lse[row1] = dead1 ? -kNegInf : m1 * kLn2 + logf(l1);
  }
}

// f32 inputs: one thread per query row, q (scaled, as the TPU kernel) and
// the output row in registers, K / V tiles of 32 keys in shared memory read
// by broadcast, the online softmax advancing 8 keys at a time.
constexpr int SBQ = 128, SBK = 32, SHD = 64, SCH = 8;

__global__ void __launch_bounds__(SBQ) flash_fwd_f32_kernel(FlashParams p) {
  __shared__ __align__(16) float Ks[SBK][SHD];
  __shared__ __align__(16) float Vs[SBK][SHD];
  const int nq = (p.Lq + SBQ - 1) / SBQ;
  const int qt = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x;
  const int row = qt * SBQ + tid;
  const bool live = row < p.Lq;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q[SHD], o[SHD];
  {
    const float4* qr = reinterpret_cast<const float4*>(Q + static_cast<long>(live ? row : 0) * p.q_sl);
#pragma unroll
    for (int d = 0; d < SHD / 4; ++d) {
      const float4 t = qr[d];
      q[4 * d] = t.x * p.scale;
      q[4 * d + 1] = t.y * p.scale;
      q[4 * d + 2] = t.z * p.scale;
      q[4 * d + 3] = t.w * p.scale;
    }
  }
#pragma unroll
  for (int d = 0; d < SHD; ++d) o[d] = 0.0f;
  float m = kNegInf, l = 0.0f;
  const float* kb = p.kbias != nullptr ? p.kbias + static_cast<long>(b) * p.Lk : nullptr;
  const float* fb =
      p.fbias != nullptr ? p.fbias + static_cast<long>(live ? row : 0) * p.Lk : nullptr;

  const int ntiles = (p.Lk + SBK - 1) / SBK;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // everyone is done with the previous tile
    for (int c = tid; c < SBK * SHD / 4; c += SBQ) {
      const int r = c / (SHD / 4), col = (c % (SHD / 4)) * 4;
      const int key = kt * SBK + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < p.Lk) {
        kv = *reinterpret_cast<const float4*>(K + static_cast<long>(key) * p.k_sl + col);
        vv = *reinterpret_cast<const float4*>(V + static_cast<long>(key) * p.v_sl + col);
      }
      *reinterpret_cast<float4*>(&Ks[r][col]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][col]) = vv;
    }
    __syncthreads();
    for (int c0 = 0; c0 < SBK; c0 += SCH) {
      float s[SCH];
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < SCH; ++j) {
        const int key = kt * SBK + c0 + j;
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < SHD; ++d) acc += q[d] * Ks[c0 + j][d];
        if (key < p.Lk) {
          if (kb != nullptr) acc += kb[key];
          if (fb != nullptr) acc += fb[key];
        } else {
          acc = -INFINITY;
        }
        s[j] = acc;
        cm = fmaxf(cm, acc);
      }
      const float mn = fmaxf(m, cm);
      const float al = expf(m - mn);
      m = mn;
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < SCH; ++j) {
        s[j] = expf(s[j] - mn);
        ps += s[j];
      }
      l = l * al + ps;
#pragma unroll
      for (int d = 0; d < SHD; ++d) {
        float acc = o[d] * al;
#pragma unroll
        for (int j = 0; j < SCH; ++j) acc += s[j] * Vs[c0 + j][d];
        o[d] = acc;
      }
    }
  }
  if (!live) return;
  const bool dead = l == 0.0f;
  const float den = dead ? 1.0f : l;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + static_cast<long>(row) * p.o_sl;
#pragma unroll
  for (int d = 0; d < SHD / 4; ++d)
    reinterpret_cast<float4*>(O)[d] = make_float4(o[4 * d] / den, o[4 * d + 1] / den,
                                                  o[4 * d + 2] / den, o[4 * d + 3] / den);
  p.lse[static_cast<long>(bh) * p.Lq + row] = dead ? -kNegInf : m + logf(l);
}

template <int HD>
inline cudaError_t launch_flash_bf16(const FlashParams& p, long blocks, cudaStream_t stream) {
  constexpr int smem = flash_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<HD><<<static_cast<unsigned>(blocks), 256, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace nova

// strides: 12 element strides, (batch, head, row) of q, k, v, o in turn.
extern "C" int nova_flash_attention(
    const void* q, const void* k, const void* v, int is_bf16,
    int B, int H, int Lq, int Lk, int D, const long* strides,
    const float* kbias, const float* fbias, float scale,
    void* o, float* lse, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.kbias = kbias;
  p.fbias = fbias;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_sl = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_sl = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_sl = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_sl = strides[11];
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.scale = scale;
  const long bh = static_cast<long>(B) * H;
  if (is_bf16) {
    const long blocks = bh * ((Lq + FBQ - 1) / FBQ);
    if (blocks > 2147483647L) return cudaErrorInvalidValue;
    if (D != 64) return cudaErrorInvalidValue;
    return launch_flash_bf16<64>(p, blocks, stream);
  }
  if (D != SHD) return cudaErrorInvalidValue;
  const long blocks = bh * ((Lq + SBQ - 1) / SBQ);
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  flash_fwd_f32_kernel<<<static_cast<unsigned>(blocks), SBQ, 0, stream>>>(p);
  return cudaGetLastError();
}
