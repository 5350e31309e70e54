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
// does in XLA) into contiguous (B, H, L, d) codes; v stays bf16.
//
// q, k, v, o are (B, H, L, d) views given by their batch / head / row strides
// with the head dim contiguous, so the model's (B, L, H, d) projections are
// read and written in place; ragged tails (L = 288, 384, 768, 1280 against
// 128-row items and 128-key tiles) are masked in the main loop. d = 64 or
// 96 (the NOVA-1.4B ViTs: flash_fwd.cuh's Tiling<96>; the bf16 core puts
// bf16(q * 96^-0.5) in shared memory once an item, as the JAX kernel scales
// q, since 96^-0.5 is no power of 2; the int8 core reads its 96-byte code
// rows as three 32-byte panels in the 32B swizzle, three s8 k-steps, and
// folds 96^-0.5 into its f32 dequant factor, as the JAX kernel). The int8
// core's bound at (2, 16, 5120, 96): 2*B*H*Lq*Lk*96 int8 operations at
// 1979 TOP/s plus as many bf16 FLOPs for p v at 989 TFLOP/s, 0.24 ms; its
// one ex2 a score takes about as long as at the bf16 core.
//
// What bounds it on this card: operations, 4*B*H*Lq*Lk*64 (0.054 ms at B*H =
// 128, L = 1280 against the 989 TFLOP/s bf16 peak), and at head dim 64 the
// one ex2 a score on the special-function units, about as long as the
// products. Design: flash_fwd.cuh's main loop (attn_fwd_kernel) without the
// running max: a persistent grid of 128-row items in two warpgroups, K / V
// tiles of 128 keys (and the tile's key-bias values) streamed by TMA, q k^T
// on wgmma (bf16 m64n128k16 with q in registers, or s8 m64n128k32 from
// 64B-swizzled shared memory), the offset, clip and ex2 in registers with
// the scale and the offset in one fused multiply-add (the kernel is built
// with -fmad=true: phase 3d gates it by tolerance, and the quant pass only
// multiplies, so contraction cannot change its codes), p rounded to bf16
// once and used both as the A fragments of p v and for l, the two
// warpgroups taking turns on the tensor cores. The bf16 core keeps q as it
// is and puts the scale on the f32 scores: hd^-0.5 = 2^-3 is a power of 2
// and bf16 has f32's exponent range, so bf16(q * 2^-3) k^T equals
// (q k^T) * 2^-3 bit for bit away from subnormals.

#include "flash_fwd.cuh"
#include "quant.cuh"

namespace nova {

// int8 core: q or k (B, H, L, D), f32 or bf16 at the given strides ->
// contiguous int8 codes clip(rint(x * (127 / max(amax, 1e-30)))), 8 a thread;
// rows of D bytes (at 96 the kernel's TMA reads them as three 32-byte panels)
template <int D>
__global__ void static_qk_quant_kernel(const void* __restrict__ x, int x_bf16, long sb, long sh,
                                       long sl, int H, int L, long chunks,
                                       const float* __restrict__ amax, int8_t* __restrict__ out) {
  constexpr int CPR = D / 8;  // chunks a row
  const long c = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const float inv = 127.0f / fmaxf(__ldg(amax), 1e-30f);
  const int d8 = static_cast<int>(c % CPR) * 8;
  const long row = (c / CPR) % L, bh = c / (static_cast<long>(CPR) * L);
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
                                   int L, int D, const float* amax, int8_t* out,
                                   cudaStream_t stream) {
  const long chunks = static_cast<long>(B) * H * L * (D / 8);
  const long blocks = (chunks + 255) / 256;
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  auto kernel = D == 64 ? static_qk_quant_kernel<64> : static_qk_quant_kernel<96>;
  kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(x, x_bf16, st[0], st[1], st[2], H, L,
                                                            chunks, amax, out);
  return cudaGetLastError();
}

}  // namespace nova

// strides: 12 element strides, (batch, head, row) of q, k, v, o in turn.
// q, k: bf16 for the bf16 core; for the int8 core f32 or bf16 (qk_bf16)
// and quantized into q8 (B*H*Lq*D) and k8 (B*H*Lk*D) first. v bf16; o bf16 or
// f32. kbias: key bias rows at row stride kb_sb (16-byte aligned, see
// fwd::key_bias_ok) or nullptr. grid and smem_bytes are the caller's launch
// plan, checked against this kernel's.
extern "C" int nova_flash_attention_static(
    const void* q, const void* k, const void* v, int qk_bf16, int B, int H, int Lq, int Lk,
    int D, const long* strides, const float* kbias, long kb_sb, const float* smax,
    const float* a_q, const float* a_k, float scale, int8_t* q8, int8_t* k8, void* o,
    int o_bf16, int grid, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool int8_core = a_q != nullptr;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || (D != 64 && D != 96))
    return cudaErrorInvalidValue;
  if (int8_core != (a_k != nullptr) || int8_core != (q8 != nullptr) ||
      int8_core != (k8 != nullptr) || smax == nullptr)
    return cudaErrorInvalidValue;
  if ((!int8_core && !qk_bf16) || !fwd::key_bias_ok(kbias, kb_sb, Lk))
    return cudaErrorInvalidValue;
  fwd::Params p;
  if (!(D == 64 ? fwd::plan<64>(B, H, Lq, Lk, grid, smem_bytes, p)
                : fwd::plan<96>(B, H, Lq, Lk, grid, smem_bytes, p)))
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[3];
  if (!bhld_map(&maps[2], v, B, H, Lk, strides + 6, fwd::BK, 2, D)) return cudaErrorInvalidValue;
  if (int8_core) {
    const long q8s[3] = {static_cast<long>(H) * Lq * D, static_cast<long>(Lq) * D, D};
    const long k8s[3] = {static_cast<long>(H) * Lk * D, static_cast<long>(Lk) * D, D};
    if (!bhld_map(&maps[0], q8, B, H, Lq, q8s, 64, 1, D) ||
        !bhld_map(&maps[1], k8, B, H, Lk, k8s, fwd::BK, 1, D))
      return cudaErrorInvalidValue;
  } else if (!bhld_map(&maps[0], q, B, H, Lq, strides, 64, 2, D) ||
             !bhld_map(&maps[1], k, B, H, Lk, strides + 3, fwd::BK, 2, D)) {
    return cudaErrorInvalidValue;
  }
  p.o = o;
  p.lse = nullptr;
  p.kbias = kbias;
  p.fbias = nullptr;
  p.smax = smax;
  p.a_q = a_q;
  p.a_k = a_k;
  p.kb_sb = kb_sb;
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_sl = strides[11];
  p.o_bf16 = o_bf16;
  p.scale = scale;
  if (!int8_core && D == 96) {
    if (kbias != nullptr) return fwd::launch<96, true, false, true, false>(maps, p, grid, stream);
    return fwd::launch<96, true, false, false, false>(maps, p, grid, stream);
  }
  if (!int8_core) {
    if (kbias != nullptr) return fwd::launch<64, true, false, true, false>(maps, p, grid, stream);
    return fwd::launch<64, true, false, false, false>(maps, p, grid, stream);
  }
  cudaError_t err = launch_qk_quant(q, qk_bf16, strides, B, H, Lq, D, a_q, q8, stream);
  if (err != cudaSuccess) return err;
  err = launch_qk_quant(k, qk_bf16, strides + 3, B, H, Lk, D, a_k, k8, stream);
  if (err != cudaSuccess) return err;
  if (D == 96) {
    if (kbias != nullptr) return fwd::launch<96, true, true, true, false>(maps, p, grid, stream);
    return fwd::launch<96, true, true, false, false>(maps, p, grid, stream);
  }
  if (kbias != nullptr) return fwd::launch<64, true, true, true, false>(maps, p, grid, stream);
  return fwd::launch<64, true, true, false, false>(maps, p, grid, stream);
}
