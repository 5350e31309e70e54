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
// D=1024 against the int8 and bf16 peaks). Design: (1) one block per row
// does LN + quant; (2) int8 product with Wqkv writes q|k|v (bf16 for the
// bf16 core, which rounds them to bf16 anyway; f32 for the others); (3) one
// block per (sample, head) holds a whole head (T=128, hd=64) on chip: the
// bf16 core runs both products on tensor cores (mma.sync m16n8k16) with the
// softmax in registers, the f32/int8 cores are one thread per query row;
// on the static path the core writes int8 av directly (the dynamic path
// writes f32 and (3b) a row pass quantizes it over the full D-wide row);
// (4) int8 product with Wo whose epilogue adds bo and the residual.

#include "int8_gemm.cuh"

namespace nova {

constexpr int AT = 128;           // tokens per sample the core handles
constexpr int AHD = 64;           // head dim the core handles
constexpr int KLD = AHD + 8;      // padded K / V row (bf16): conflict-free ldmatrix
enum { CORE_F32 = 0, CORE_BF16 = 1, CORE_INT8 = 2 };

__device__ __forceinline__ void store_av(float v, long idx, const float* a_av, int8_t* av8,
                                         float* avf) {
  if (a_av != nullptr)
    av8[idx] = q8_rint(v * (1.0f / static_scale(a_av)));
  else
    avf[idx] = v;
}

// bf16 core: block (head, sample), 8 warps of 16 query rows each.
__global__ void __launch_bounds__(256)
    attn_core_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, int D, float scale,
                          const float* smax, const float* a_av, int8_t* av8, float* avf) {
  __shared__ __align__(16) __nv_bfloat16 Ks[AT * KLD];
  __shared__ __align__(16) __nv_bfloat16 Vs[AT * KLD];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long ld = 3L * D;
  const __nv_bfloat16* base = qkv + static_cast<long>(b) * AT * ld + h * AHD;

  for (int c = tid; c < AT * 8; c += 256) {  // K and V rows, 16 bytes at a time
    const int r = c >> 3, ch = c & 7;
    *reinterpret_cast<uint4*>(&Ks[r * KLD + ch * 8]) =
        *reinterpret_cast<const uint4*>(base + r * ld + D + ch * 8);
    *reinterpret_cast<uint4*>(&Vs[r * KLD + ch * 8]) =
        *reinterpret_cast<const uint4*>(base + r * ld + 2 * D + ch * 8);
  }
  unsigned qa[4][4];  // A fragments of this warp's 16 query rows, from global
  const __nv_bfloat16* q0 = base + static_cast<long>(warp * 16 + g) * ld;
  const __nv_bfloat16* q1 = q0 + 8 * ld;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    qa[ks][0] = *reinterpret_cast<const unsigned*>(q0 + ks * 16 + tig * 2);
    qa[ks][1] = *reinterpret_cast<const unsigned*>(q1 + ks * 16 + tig * 2);
    qa[ks][2] = *reinterpret_cast<const unsigned*>(q0 + ks * 16 + 8 + tig * 2);
    qa[ks][3] = *reinterpret_cast<const unsigned*>(q1 + ks * 16 + 8 + tig * 2);
  }
  __syncthreads();

  float s[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
  // ldmatrix lanes: K fragments (keys x d, d contiguous) for two n8 key
  // tiles; V fragments (keys x d, transposed on load) for two n8 d tiles
  const int k_key = (lane & 7) + (lane >> 4) * 8, k_d = ((lane >> 3) & 1) * 8;
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8, v_d = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int nt = 0; nt < 16; nt += 2) {
      unsigned r[4];
      ldmatrix_x4(r, &Ks[(nt * 8 + k_key) * KLD + ks * 16 + k_d]);
      mma_bf16(s[nt], qa[ks], r);
      mma_bf16(s[nt + 1], qa[ks], r + 2);
    }

  // softmax over the 128 keys of rows g (s[.][0..1]) and g+8 (s[.][2..3]);
  // a row's values sit in the 4 threads of one quad
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = s[nt][i] * scale;
    m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
    m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
  }
  if (smax != nullptr) {
    const float sm = __ldg(smax);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = expf(fminf(s[nt][i] - sm, 20.0f));
  } else {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
    }
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  if (smax != nullptr) {
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    s[nt][0] = s[nt][0] / l0;
    s[nt][1] = s[nt][1] / l0;
    s[nt][2] = s[nt][2] / l1;
    s[nt][3] = s[nt][3] / l1;
  }

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // keys 16j..16j+15: the C fragments of S are P's A fragments
    const unsigned pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                            pack_bf16(s[2 * j][2], s[2 * j][3]),
                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      unsigned r[4];
      ldmatrix_x4_trans(r, &Vs[(j * 16 + v_key) * KLD + nt * 8 + v_d]);
      mma_bf16(o[nt], pa, r);
      mma_bf16(o[nt + 1], pa, r + 2);
    }
  }

  const long row0 = static_cast<long>(b) * AT + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = h * AHD + nt * 8 + tig * 2;
    store_av(o[nt][0], row0 * D + col, a_av, av8, avf);
    store_av(o[nt][1], row0 * D + col + 1, a_av, av8, avf);
    store_av(o[nt][2], (row0 + 8) * D + col, a_av, av8, avf);
    store_av(o[nt][3], (row0 + 8) * D + col + 1, a_av, av8, avf);
  }
}

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
    int8_t* q1, float* sx1, void* qkv, int8_t* av8, float* avf, float* sxo,
    void* y, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * T;
  if (T != AT || D != H * AHD || core < CORE_F32 || core > CORE_INT8) return cudaErrorInvalidValue;
  const bool static_acts = a_in != nullptr;
  if (static_acts != (a_av != nullptr)) return cudaErrorInvalidValue;
  if (!static_acts && avf == nullptr) return cudaErrorInvalidValue;

  cudaError_t err = launch_row_quant(x, x_bf16, M, D, ln_w, ln_b, vec_bf16, a_in, q1, sx1,
                                     stream);
  if (err != cudaSuccess) return err;

  EpiParams e1 = {};
  e1.sx_rows = sx1;
  e1.w_scale = sqkv;
  e1.bias = bqkv;
  e1.bias_bf16 = vec_bf16;
  e1.out = qkv;
  e1.out_bf16 = core == CORE_BF16;
  err = launch_gemm_s8<EPI_STORE>(q1, wqkv_t, M, 3 * D, D, e1, stream);
  if (err != cudaSuccess) return err;

  const dim3 grid(H, B);
  if (core == CORE_BF16)
    attn_core_bf16_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), D, scale, a_smax, a_av, av8, avf);
  else if (core == CORE_F32)
    attn_core_scalar_kernel<CORE_F32><<<grid, AT, 0, stream>>>(
        static_cast<const float*>(qkv), D, scale, a_smax, a_av, av8, avf);
  else
    attn_core_scalar_kernel<CORE_INT8><<<grid, AT, 0, stream>>>(
        static_cast<const float*>(qkv), D, scale, a_smax, a_av, av8, avf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
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
  return launch_gemm_s8<EPI_RESIDUAL>(av8, wo_t, M, D, D, e2, stream);
}
