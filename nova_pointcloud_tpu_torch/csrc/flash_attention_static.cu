// Serving attention with a calibrated softmax offset, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_static
// (nova_pointcloud_tpu/ops/pallas/flash_attention.py, _static_kernel and
// _static_kernel_int8):
//
//   s   = bf16(q * hd^-0.5) k^T                (f32 sums; bf16 core)
//       | int32(q8 k8^T) * a_q a_k / 127^2 * hd^-0.5        (int8 core)
//   p   = bf16(exp(min(s + kbias - smax, 20)))
//   [o | l] = p [v | 1]                         (f32 sums: l = sum of bf16(p))
//   out = o / max(l, 1e-30)                     in q's dtype
//
// smax is the calibrated max logit (a device scalar), so there is no running
// max and nothing to rescale: key tiles stream through and o and l only
// accumulate. kbias is a key bias (B, Lk), read with the batch index bh / H;
// -inf keys give p = 0, and a row whose keys are all -inf ends with l = 0 and
// o = 0. The int8 core's q and k are quantized with the static scales
// 127 / a_q, 127 / a_k by a small pass before the kernel (as the JAX function
// does in XLA); v stays bf16.
//
// q, k, v, o are (B, H, L, 64) views given by their batch / head / row strides
// with the head dim contiguous, so the model's (B, L, H, 64) projections are
// read and written in place; ragged tails (L = 288, 384, 768, 1280 against
// 128-row and 64-key tiles) are masked here.
//
// What bounds it on this card: operations, 4*B*H*Lq*Lk*64 (0.054 ms at B*H =
// 128, L = 1280 against the 989 TFLOP/s bf16 peak). Design: flash_attention.cu's
// tiling without its rescale chain. One block per (batch*head,
// 128-query tile), 8 warps of 16 query rows whose q fragments stay in
// registers; K and V tiles of 64 keys double-buffered through cp.async; q k^T
// on tensor cores (mma.sync bf16 m16n8k16, or s8 m16n8k32 for the int8 core),
// the offset, clip and exp (ex2) in registers, p rounded to bf16 once and
// used both as the A fragments of p v and for l. No TMA, no wgmma.

#include "quant.cuh"
#include "tensor_core.cuh"

namespace nova {

constexpr float kLog2eStatic = 1.4426950408889634f;
constexpr int ZBQ = 128;  // query rows per block (8 warps x 16)
constexpr int ZBK = 64;   // keys per tile
constexpr int ZHD = 64;   // head dim
constexpr int ZLD = ZHD + 8;    // padded bf16 smem row (elements): conflict-free ldmatrix
constexpr int ZLD8 = ZHD + 16;  // padded int8 smem row (bytes)

__device__ __forceinline__ float ex2_static(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16_s(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct StaticParams {
  const void* q;  // bf16 (bf16 core) or int8 (int8 core)
  const void* k;
  const __nv_bfloat16* v;
  void* o;
  const float* kbias;  // (B, Lk) or nullptr
  const float* smax;   // scalar
  const float* a_q;    // int8 core: calibrated amax of q and k
  const float* a_k;
  long q_sb, q_sh, q_sl;  // strides in elements: batch, head, row
  long k_sb, k_sh, k_sl;
  long v_sb, v_sh, v_sl;
  long o_sb, o_sh, o_sl;
  int H, Lq, Lk, o_bf16;
  float scale;
};

template <bool INT8>
struct StaticTile {  // bytes of one K tile and of one K + V buffer
  static constexpr int kK = INT8 ? ZBK * ZLD8 : ZBK * ZLD * 2;
  static constexpr int kBuf = kK + ZBK * ZLD * 2;
};

template <bool INT8>
__global__ void __launch_bounds__(256, 2) flash_static_kernel(StaticParams p) {
  constexpr int KB = StaticTile<INT8>::kK;
  constexpr int BUF = StaticTile<INT8>::kBuf;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nq = (p.Lq + ZBQ - 1) / ZBQ;
  const int qt = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* V = p.v + b * p.v_sb + h * p.v_sh;
  const int ntiles = (p.Lk + ZBK - 1) / ZBK;

  auto load_tile = [&](int buf, int kt) {
    unsigned char* Ks = smem + buf * BUF;
    __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(Ks + KB);
    if (INT8) {  // 64 keys x 64 bytes: one 16-byte chunk a thread
      const int8_t* K = static_cast<const int8_t*>(p.k) + b * p.k_sb + h * p.k_sh;
      const int r = tid / 4, col = (tid % 4) * 16, key = kt * ZBK + r;
      const bool ok = key < p.Lk;
      cp_async16(Ks + r * ZLD8 + col, K + static_cast<long>(ok ? key : 0) * p.k_sl + col, ok);
    } else {  // 64 keys x 128 bytes: two chunks a thread
      const __nv_bfloat16* K =
          static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
      __nv_bfloat16* Kb = reinterpret_cast<__nv_bfloat16*>(Ks);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * 256, r = c / 8, col = (c % 8) * 8, key = kt * ZBK + r;
        const bool ok = key < p.Lk;
        cp_async16(Kb + r * ZLD + col, K + static_cast<long>(ok ? key : 0) * p.k_sl + col, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 256, r = c / 8, col = (c % 8) * 8, key = kt * ZBK + r;
      const bool ok = key < p.Lk;
      cp_async16(Vs + r * ZLD + col, V + static_cast<long>(ok ? key : 0) * p.v_sl + col, ok);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // this thread's two query rows (g and g + 8 of the warp's 16)
  const int row0 = qt * ZBQ + warp * 16 + g, row1 = row0 + 8;
  const bool live0 = row0 < p.Lq, live1 = row1 < p.Lq;
  // A fragments of q: bf16 q * scale rounded to bf16 (4 k-steps of 16), or
  // the int8 codes (2 k-steps of 32 bytes)
  unsigned qa[4][4];
  if (INT8) {
    const int8_t* Q = static_cast<const int8_t*>(p.q) + b * p.q_sb + h * p.q_sh;
    const int8_t* q0 = Q + static_cast<long>(live0 ? row0 : 0) * p.q_sl;
    const int8_t* q1 = Q + static_cast<long>(live1 ? row1 : 0) * p.q_sl;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const unsigned a0 = *reinterpret_cast<const unsigned*>(q0 + ks * 32 + tig * 4);
      const unsigned a1 = *reinterpret_cast<const unsigned*>(q1 + ks * 32 + tig * 4);
      const unsigned a2 = *reinterpret_cast<const unsigned*>(q0 + ks * 32 + 16 + tig * 4);
      const unsigned a3 = *reinterpret_cast<const unsigned*>(q1 + ks * 32 + 16 + tig * 4);
      qa[ks][0] = live0 ? a0 : 0u;
      qa[ks][1] = live1 ? a1 : 0u;
      qa[ks][2] = live0 ? a2 : 0u;
      qa[ks][3] = live1 ? a3 : 0u;
    }
  } else {
    const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* q0 = Q + static_cast<long>(live0 ? row0 : 0) * p.q_sl;
    const __nv_bfloat16* q1 = Q + static_cast<long>(live1 ? row1 : 0) * p.q_sl;
    auto scaled = [&](const __nv_bfloat16* r, bool live) -> unsigned {
      if (!live) return 0u;
      const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(r);
      return pack_bf16(__low2float(t) * p.scale, __high2float(t) * p.scale);
    };
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      qa[ks][0] = scaled(q0 + ks * 16 + tig * 2, live0);
      qa[ks][1] = scaled(q1 + ks * 16 + tig * 2, live1);
      qa[ks][2] = scaled(q0 + ks * 16 + 8 + tig * 2, live0);
      qa[ks][3] = scaled(q1 + ks * 16 + 8 + tig * 2, live1);
    }
  }
  const float* kb = p.kbias != nullptr ? p.kbias + static_cast<long>(b) * p.Lk : nullptr;
  const float smax = *p.smax;
  float dq = 0.0f;  // int8 core: the folded dequant factor
  if (INT8) {
    const float aq = fmaxf(*p.a_q, 1e-30f), ak = fmaxf(*p.a_k, 1e-30f);
    dq = aq * ak / (127.0f * 127.0f) * p.scale;
  }

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;  // this thread's share of the denominators

  // ldmatrix lanes. bf16 core: K fragments (keys x d) for two n8 key tiles;
  // int8 core: K fragments as the int8 GEMM's W operand; V (keys x d,
  // transposed on load) for two n8 d tiles
  const int k_key = (lane & 7) + (lane >> 4) * 8, k_d = ((lane >> 3) & 1) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8, v_d = (lane >> 4) * 8;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; everyone is done with tile kt - 1
    if (kt + 1 < ntiles) load_tile((kt + 1) & 1, kt + 1);
    cp_async_commit();
    const unsigned char* Ks = smem + (kt & 1) * BUF;
    const __nv_bfloat16* Vs = reinterpret_cast<const __nv_bfloat16*>(Ks + KB);

    float s[8][4];
    if (INT8) {
      int si[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) si[nt][i] = 0;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          unsigned r[4];
          ldmatrix_x4(r, Ks + (nj * 16 + b_row) * ZLD8 + ks * 32 + b_col);
          mma_s8(si[2 * nj], qa[ks], r);
          mma_s8(si[2 * nj + 1], qa[ks], r + 2);
        }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = static_cast<float>(si[nt][i]) * dq;
    } else {
      const __nv_bfloat16* Kb = reinterpret_cast<const __nv_bfloat16*>(Ks);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          unsigned r[4];
          ldmatrix_x4(r, Kb + (nt * 8 + k_key) * ZLD + ks * 16 + k_d);
          mma_bf16(s[nt], qa[ks], r);
          mma_bf16(s[nt + 1], qa[ks], r + 2);
        }
    }

    // p = bf16(exp(min(s + kbias - smax, 20))); keys past Lk score -inf
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = kt * ZBK + nt * 8 + tig * 2 + c;
        float off = -INFINITY;
        if (key < p.Lk) off = (kb != nullptr ? kb[key] : 0.0f) - smax;
        const float e0 = round_bf16_s(ex2_static(fminf(s[nt][c] + off, 20.0f) * kLog2eStatic));
        const float e1 =
            round_bf16_s(ex2_static(fminf(s[nt][2 + c] + off, 20.0f) * kLog2eStatic));
        s[nt][c] = e0;
        s[nt][2 + c] = e1;
        l0 += e0;
        l1 += e1;
      }
#pragma unroll
    for (int j = 0; j < ZBK / 16; ++j) {  // keys 16j..16j+15: S's C fragments are P's A fragments
      const unsigned pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Vs + (j * 16 + v_key) * ZLD + nt * 8 + v_d);
        mma_bf16(o[nt], pa, r);
        mma_bf16(o[nt + 1], pa, r + 2);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {  // a row's values sit in one quad
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    const long off0 = b * p.o_sb + h * p.o_sh + static_cast<long>(row0) * p.o_sl + col;
    const long off1 = b * p.o_sb + h * p.o_sh + static_cast<long>(row1) * p.o_sl + col;
    if (p.o_bf16) {
      __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o);
      if (live0)
        *reinterpret_cast<__nv_bfloat162*>(O + off0) =
            __floats2bfloat162_rn(o[nt][0] / d0, o[nt][1] / d0);
      if (live1)
        *reinterpret_cast<__nv_bfloat162*>(O + off1) =
            __floats2bfloat162_rn(o[nt][2] / d1, o[nt][3] / d1);
    } else {
      float* O = static_cast<float*>(p.o);
      if (live0) *reinterpret_cast<float2*>(O + off0) = make_float2(o[nt][0] / d0, o[nt][1] / d0);
      if (live1) *reinterpret_cast<float2*>(O + off1) = make_float2(o[nt][2] / d1, o[nt][3] / d1);
    }
  }
}

// int8 core: q or k (B, H, L, 64), f32 or bf16 at the given strides ->
// contiguous int8 codes clip(rint(x * (127 / max(amax, 1e-30)))), 8 a thread
__global__ void static_qk_quant_kernel(const void* __restrict__ x, int x_bf16, long sb, long sh,
                                       long sl, int H, int L, long chunks,
                                       const float* __restrict__ amax, int8_t* __restrict__ out) {
  const long c = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const float inv = 127.0f / fmaxf(__ldg(amax), 1e-30f);
  const int d8 = static_cast<int>(c % 8) * 8;
  const long row = (c / 8) % L, bh = c / (8L * L);
  const long base = (bh / H) * sb + (bh % H) * sh + row * sl + d8;
  char4 lo, hi;
  lo.x = q8_rint(ld_any(x, base + 0, x_bf16) * inv);
  lo.y = q8_rint(ld_any(x, base + 1, x_bf16) * inv);
  lo.z = q8_rint(ld_any(x, base + 2, x_bf16) * inv);
  lo.w = q8_rint(ld_any(x, base + 3, x_bf16) * inv);
  hi.x = q8_rint(ld_any(x, base + 4, x_bf16) * inv);
  hi.y = q8_rint(ld_any(x, base + 5, x_bf16) * inv);
  hi.z = q8_rint(ld_any(x, base + 6, x_bf16) * inv);
  hi.w = q8_rint(ld_any(x, base + 7, x_bf16) * inv);
  reinterpret_cast<char4*>(out + c * 8)[0] = lo;
  reinterpret_cast<char4*>(out + c * 8)[1] = hi;
}

inline cudaError_t launch_qk_quant(const void* x, int x_bf16, const long* st, int B, int H,
                                   int L, const float* amax, int8_t* out, cudaStream_t stream) {
  const long chunks = static_cast<long>(B) * H * L * 8;
  const long blocks = (chunks + 255) / 256;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  static_qk_quant_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      x, x_bf16, st[0], st[1], st[2], H, L, chunks, amax, out);
  return cudaGetLastError();
}

template <bool INT8>
inline cudaError_t launch_static(const StaticParams& p, long blocks, cudaStream_t stream) {
  constexpr int smem = 2 * StaticTile<INT8>::kBuf;
  cudaError_t err = cudaFuncSetAttribute(flash_static_kernel<INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_static_kernel<INT8><<<static_cast<unsigned>(blocks), 256, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace nova

// strides: 12 element strides, (batch, head, row) of q, k, v, o in turn.
// q, k: bf16 for the bf16 core; for the int8 core f32 or bf16 (qk_bf16) and
// quantized into q8 (B*H*Lq*64) and k8 (B*H*Lk*64) first. v bf16; o bf16 or f32.
extern "C" int nova_flash_attention_static(
    const void* q, const void* k, const void* v, int qk_bf16, int B, int H, int Lq, int Lk,
    int D, const long* strides, const float* kbias, const float* smax, const float* a_q,
    const float* a_k, float scale, int8_t* q8, int8_t* k8, void* o, int o_bf16,
    void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D != ZHD) return cudaErrorInvalidValue;
  const bool int8_core = a_q != nullptr;
  if (int8_core != (a_k != nullptr) || int8_core != (q8 != nullptr)) return cudaErrorInvalidValue;
  if (!int8_core && !qk_bf16) return cudaErrorInvalidValue;
  StaticParams p;
  p.q = q;
  p.k = k;
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = o;
  p.kbias = kbias;
  p.smax = smax;
  p.a_q = a_q;
  p.a_k = a_k;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_sl = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_sl = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_sl = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_sl = strides[11];
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.o_bf16 = o_bf16;
  p.scale = scale;
  const long blocks = static_cast<long>(B) * H * ((Lq + ZBQ - 1) / ZBQ);
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  if (!int8_core) return launch_static<false>(p, blocks, stream);
  cudaError_t err = launch_qk_quant(q, qk_bf16, strides, B, H, Lq, a_q, q8, stream);
  if (err != cudaSuccess) return err;
  err = launch_qk_quant(k, qk_bf16, strides + 3, B, H, Lk, a_k, k8, stream);
  if (err != cudaSuccess) return err;
  p.q = q8;
  p.k = k8;
  p.q_sb = static_cast<long>(H) * Lq * ZHD, p.q_sh = static_cast<long>(Lq) * ZHD, p.q_sl = ZHD;
  p.k_sb = static_cast<long>(H) * Lk * ZHD, p.k_sh = static_cast<long>(Lk) * ZHD, p.k_sl = ZHD;
  return launch_static<true>(p, blocks, stream);
}
