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
// written in place.
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
// score. f32 inputs take a SIMT path (one thread per query row), written for
// exactness, not speed. Built with fused multiply-add: there is no rounding
// identity to keep with a reference, unlike the int8 kernels.

#include "flash_fwd.cuh"
#include "quant.cuh"

namespace nova {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

// the f32 SIMT kernel's arguments
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;          // (B*H, Lq)
  const float* kbias;  // key bias rows (B, >= Lk) at row stride kb_sb, or nullptr
  const float* fbias;  // (Lq, Lk) or nullptr
  long kb_sb;
  long q_sb, q_sh, q_sl;  // strides in elements: batch, head, row
  long k_sb, k_sh, k_sl;
  long v_sb, v_sh, v_sl;
  long o_sb, o_sh, o_sl;
  int H, Lq, Lk;
  float scale;
};

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
  const float* kb = p.kbias != nullptr ? p.kbias + b * p.kb_sb : nullptr;
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

}  // namespace nova

// strides: 12 element strides, (batch, head, row) of q, k, v, o in turn.
// kbias: key bias rows at row stride kb_sb (16-byte aligned, see
// fwd::key_bias_ok) or nullptr; fbias (Lq, Lk) or nullptr. bf16: grid and
// smem_bytes are the caller's launch plan, checked against this kernel's.
extern "C" int nova_flash_attention(
    const void* q, const void* k, const void* v, int is_bf16,
    int B, int H, int Lq, int Lk, int D, const long* strides,
    const float* kbias, long kb_sb, const float* fbias, float scale,
    void* o, float* lse, int grid, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D != 64) return cudaErrorInvalidValue;
  if (!fwd::key_bias_ok(kbias, kb_sb, Lk) || (kbias != nullptr && fbias != nullptr))
    return cudaErrorInvalidValue;
  if (is_bf16) {
    fwd::Params p;
    if (!fwd::plan(B, H, Lq, Lk, grid, smem_bytes, p)) return cudaErrorInvalidConfiguration;
    CUtensorMap maps[3];
    if (!bhld_map(&maps[0], q, B, H, Lq, strides, 64) ||
        !bhld_map(&maps[1], k, B, H, Lk, strides + 3, fwd::BK) ||
        !bhld_map(&maps[2], v, B, H, Lk, strides + 6, fwd::BK))
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
    if (fbias != nullptr) return fwd::launch<false, false, false, true>(maps, p, grid, stream);
    if (kbias != nullptr) return fwd::launch<false, false, true, false>(maps, p, grid, stream);
    return fwd::launch<false, false, false, false>(maps, p, grid, stream);
  }
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.kbias = kbias;
  p.fbias = fbias;
  p.kb_sb = kb_sb;
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_sl = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_sl = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_sl = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_sl = strides[11];
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.scale = scale;
  const long blocks = static_cast<long>(B) * H * ((Lq + SBQ - 1) / SBQ);
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  flash_fwd_f32_kernel<<<static_cast<unsigned>(blocks), SBQ, 0, stream>>>(p);
  return cudaGetLastError();
}
