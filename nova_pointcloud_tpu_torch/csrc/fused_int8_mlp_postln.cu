// Post-norm int8 MLP sub-block of the NOVA ViT block, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_int8_mlp_postln
// (nova_pointcloud_tpu/ops/pallas/fused_block.py, _mlp_postln_kernel):
//
//   a = gelu(q8(x) @ W1 * sx * s1 + b1)            exact-erf gelu (A-S polynomial)
//   o = q8(a) @ W2 * sa * s2 + b2
//   y = x + LN(o) * ln_w + ln_b                    LN eps from the caller (1e-5)
//
// with both quant sites static (calibrated a_x / a_gelu: multiply by 1/s) or
// per row (divide by the row's amax / 127). The weights come K-major: w1t (F, D)
// and w2t (D, F) row-major.
//
// What bounds it on this card: the two int8 products, 4*M*D*F operations
// (0.087 ms at M=10240, D=1024, F=4096 against the 1979 TOP/s int8 peak);
// its bytes (x in, y out, 8 MB of weights, the int8 rows between the
// launches) take about 0.07 ms. Design: three launches (four on the per-row
// path).
//   (1) the row pass quantizes x;
//   (2) fc1 on the wgmma + TMA GEMM (int8_wgmma.cuh), whose epilogue
//       dequantizes, adds b1, applies gelu and, on the static path,
//       quantizes to int8 (the per-row path writes f32, and (2b) a row pass
//       quantizes each 4096-wide mid row, which needs its amax first);
//   (3) fc2 with the post-LN and the residual in its epilogue. A row's D
//       columns span D / 256 output tiles, so fc2 runs as clusters of
//       D / 256 blocks: block rank r owns n-tile r of the cluster's m-tile,
//       the clusters walk the m-tiles (persistent). Each consumer
//       warpgroup dequantizes its 64 x 256 tile in registers, sums each
//       row over its columns (a row's columns sit in the four threads of a
//       quad), and the blocks exchange the sums through distributed shared
//       memory: each writes its own, arrives on every block's mbarrier, and
//       reads all the others' once its own barrier completes. The LN is
//       two-pass (the mean, then the mean of squared deviations: two
//       exchanges), and every block adds the partial sums in rank order,
//       so all blocks of a cluster derive bitwise the same mean and rstd.
//       The partial sums are double-buffered by tile parity: a block
//       writes tile n + 2's sums only after every block has arrived for
//       tile n + 1, by which time all have read tile n's.
// The int8 mid row (M x F bytes) is the one intermediate that goes through
// device memory; the f32 product of the first design (M x D x 4 bytes,
// written and read again) and its row pass are gone.

#include "int8_wgmma.cuh"

namespace nova {
namespace pln {

using wg8::BK;
using wg8::BM;
using wg8::BN;
using wg8::CONSUMERS;
using wg8::STAGES;
using wg8::THREADS;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int VECS = 4;         // column vectors: w_scale, bias, ln_w, ln_b
constexpr int OFF_EPI = wg8::OFF_BAR + 2 * STAGES * 8;
constexpr int EPI_BYTES = VECS * BN * 4;  // a consumer's staged column vectors
constexpr int OFF_PART = OFF_EPI + CONSUMERS * EPI_BYTES;
constexpr int PART_BYTES = 64 * 4;  // a consumer's 64 row sums of one exchange
// [consumer][tile parity][round]: the row sums, then their mbarriers
constexpr int OFF_RBAR = OFF_PART + CONSUMERS * 2 * 2 * PART_BYTES;
constexpr int SMEM = OFF_RBAR + CONSUMERS * 2 * 2 * 8 + 1024;

struct Params {
  const float* sa_rows;  // per-row scales of q2, or nullptr and
  const float* sa_amax;  // its calibrated amax
  const float* w_scale;  // (D,)
  const void* bias;      // (D,), and the LN's affine parameters
  const void* ln_w;
  const void* ln_b;
  int vec_bf16;
  float eps;
  const void* x;  // the residual (M, D), in y's dtype
  void* y;
  int M, D, m_tiles, ktiles;
};

template <bool XBF16>
__global__ void __launch_bounds__(THREADS, 1)
    fc2_postln_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warp-uniform
  const int rank = static_cast<int>(cluster_rank()), cs = static_cast<int>(cluster_size());
  const int first = static_cast<int>(cluster_id()), stride = static_cast<int>(cluster_count());
  wg8::Ring ring(base);
  if (tid == 0) {
    ring.init();
    // each exchange barrier: lanes 0 .. cs - 1 of the four warps of the
    // same consumer in every block of the cluster arrive once
    for (int i = 0; i < CONSUMERS * 4; ++i) mbar_init(base + OFF_RBAR + 8 * i, 4 * cs);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // no block arrives on another's barriers before they exist

  if (wg == 0) {  // the producer; its warpgroup stays for the last cluster barrier
    setmaxnreg_dec<wg8::PRODUCER_REGS>();
    if (tid == 0)
      for (int mt = first; mt < p.m_tiles; mt += stride)
        ring.load_tile(&tm_a, &tm_w, mt, rank, p.ktiles);
  } else {
    setmaxnreg_inc<wg8::CONSUMER_REGS>();
    const int c = wg - 1, lt = tid & 127, warp = lt >> 5, lane = lt & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = rank * BN;
    const uint32_t s_vec = base + OFF_EPI + c * EPI_BYTES;  // VECS x BN floats
    const float fd = static_cast<float>(p.D);
    int acc[128];
    int n = 0;  // this consumer's tiles so far: the parity of the exchange buffers
    // the row sums (a0 for row g, a1 for g + 8 of this warp's 16) over the
    // cluster: this block's into its buffer, then every block's, in rank order
    auto exchange = [&](int round, float a0, float a1, float& s0, float& s1) {
      const int slot = (c * 2 + (n & 1)) * 2 + round;
      const uint32_t part = base + OFF_PART + slot * PART_BYTES, bar = base + OFF_RBAR + 8 * slot;
      const int r = 16 * warp + g;
      if (t == 0) {
        sts_f32(part + 4 * r, a0);
        sts_f32(part + 4 * (r + 8), a1);
      }
      __syncwarp();
      if (lane < cs) mbar_arrive_cluster(mapa(bar, lane));
      mbar_wait_cluster(bar, (n >> 1) & 1);
      s0 = 0.0f;
      s1 = 0.0f;
      for (int k = 0; k < cs; ++k) {
        s0 += ld_cluster_f32(mapa(part + 4 * r, k));
        s1 += ld_cluster_f32(mapa(part + 4 * (r + 8), k));
      }
    };

    for (int mt = first; mt < p.m_tiles; mt += stride, ++n) {
      // accumulator element i: row 16 warp + g + 8 ((i >> 1) & 1), column
      // 8 (i >> 2) + 2 t + (i & 1) of this warpgroup's 64 x 256
      const int row0 = mt * BM + 64 * c + 16 * warp + g;
      // loaded while the products run: two columns of each vector a
      // thread, the rows' activation scales, the residual rows into L2
      float my_vec[VECS][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + lt + 128 * h;
        my_vec[0][h] = p.w_scale[col];
        my_vec[1][h] = ld_any(p.bias, col, p.vec_bf16);
        my_vec[2][h] = ld_any(p.ln_w, col, p.vec_bf16);
        my_vec[3][h] = ld_any(p.ln_b, col, p.vec_bf16);
      }
      auto row_scale = [&](int row) {
        if (row >= p.M) return 0.0f;
        return p.sa_rows != nullptr ? p.sa_rows[row] : static_scale(p.sa_amax);
      };
      const float sa0 = row_scale(row0), sa1 = row_scale(row0 + 8);
      constexpr int XB = XBF16 ? 2 : 4;
      {  // row lt / 2 of the 64, its half lt % 2, in 128-byte lines
        const int r = mt * BM + 64 * c + (lt >> 1);
        if (r < p.M) {
          const char* q = static_cast<const char*>(p.x) +
                          (static_cast<long>(r) * p.D + n0) * XB + (lt & 1) * (BN * XB / 2);
          for (int off = 0; off < BN * XB / 2; off += 128)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(q + off));
        }
      }

      ring.products(acc, p.ktiles, c, lane);

      named_sync(1 + c, 128);  // this warpgroup's last epilogue has read the staged vectors
#pragma unroll
      for (int k = 0; k < VECS; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sts_f32(s_vec + 4 * (k * BN + lt + 128 * h), my_vec[k][h]);
      named_sync(1 + c, 128);

      // o = acc * sa * s2 + b2, as the GEMM's EPI_STORE; the rows' sums
      float v[128];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 ws = lds_f2(s_vec + 4 * col), bs = lds_f2(s_vec + 4 * (BN + col));
        v[4 * j] = static_cast<float>(acc[4 * j]) * sa0 * ws.x + bs.x;
        v[4 * j + 1] = static_cast<float>(acc[4 * j + 1]) * sa0 * ws.y + bs.y;
        v[4 * j + 2] = static_cast<float>(acc[4 * j + 2]) * sa1 * ws.x + bs.x;
        v[4 * j + 3] = static_cast<float>(acc[4 * j + 3]) * sa1 * ws.y + bs.y;
        sum0 += v[4 * j] + v[4 * j + 1];
        sum1 += v[4 * j + 2] + v[4 * j + 3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {  // a row's columns sit in one quad
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      float mu0, mu1;
      exchange(0, sum0, sum1, mu0, mu1);
      mu0 = mu0 / fd;
      mu1 = mu1 / fd;
      float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float e0 = v[4 * j] - mu0, e1 = v[4 * j + 1] - mu0;
        const float e2 = v[4 * j + 2] - mu1, e3 = v[4 * j + 3] - mu1;
        d0 += e0 * e0 + e1 * e1;
        d1 += e2 * e2 + e3 * e3;
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, o);
        d1 += __shfl_xor_sync(0xffffffffu, d1, o);
      }
      float var0, var1;
      exchange(1, d0, d1, var0, var1);
      const float rstd0 = 1.0f / sqrtf(var0 / fd + p.eps);
      const float rstd1 = 1.0f / sqrtf(var1 / fd + p.eps);

      // y = x + ((o - mean) * rstd * ln_w + ln_b), in the order of
      // fused_block._ln; the residual pairs of JB column groups loaded
      // together
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += wg8::JB) {
        float2 r[wg8::JB][2];
#pragma unroll
        for (int jj = 0; jj < wg8::JB; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = row0 + 8 * half;
            const long o = static_cast<long>(row) * p.D + n0 + 8 * (j0 + jj) + 2 * t;
            r[jj][half] = make_float2(0.0f, 0.0f);
            if (row < p.M)
              r[jj][half] = XBF16 ? __bfloat1622float2(
                                        static_cast<const __nv_bfloat162*>(p.x)[o >> 1])
                                  : static_cast<const float2*>(p.x)[o >> 1];
          }
#pragma unroll
        for (int jj = 0; jj < wg8::JB; ++jj) {
          const int j = j0 + jj, col = 8 * j + 2 * t;
          const float2 lw = lds_f2(s_vec + 4 * (2 * BN + col));
          const float2 lb = lds_f2(s_vec + 4 * (3 * BN + col));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = row0 + 8 * half;
            if (row >= p.M) continue;
            const float mu = half ? mu1 : mu0, rstd = half ? rstd1 : rstd0;
            const float y0 = r[jj][half].x + ((v[4 * j + 2 * half] - mu) * rstd * lw.x + lb.x);
            const float y1 =
                r[jj][half].y + ((v[4 * j + 2 * half + 1] - mu) * rstd * lw.y + lb.y);
            const long o = static_cast<long>(row) * p.D + n0 + col;
            if (XBF16)
              static_cast<__nv_bfloat162*>(p.y)[o >> 1] = __floats2bfloat162_rn(y0, y1);
            else
              static_cast<float2*>(p.y)[o >> 1] = make_float2(y0, y1);
          }
        }
      }
    }
  }
  cluster_sync();  // no block leaves while another may still read its row sums
}

// The launch plan's checks (the wrapper computes the plan: ops/kernels/
// fused_block.mlp_postln_plan): a cluster of D / BN blocks, at most the
// portable 8; K a multiple of BK; whole clusters, at most one an m-tile.
inline bool plan(int M, int D, int F, int grid, int cluster, int smem_bytes, int& m_tiles) {
  if (M <= 0 || D <= 0 || F <= 0 || D % BN != 0 || F % BK != 0) return false;
  if (cluster != D / BN || cluster > MAX_CLUSTER) return false;
  m_tiles = (M + BM - 1) / BM;
  return grid >= cluster && grid % cluster == 0 && grid / cluster <= m_tiles && smem_bytes == SMEM;
}

template <bool XBF16>
inline cudaError_t set_smem() {
  return cudaFuncSetAttribute(fc2_postln_kernel<XBF16>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

inline cudaLaunchConfig_t cluster_config(int grid, int cluster, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool XBF16>
inline cudaError_t launch(const int8_t* q2, const int8_t* w2t, int F, const Params& p, int grid,
                          int cluster, int smem_bytes, cudaStream_t stream) {
  int m_tiles;
  if (!plan(p.M, p.D, F, grid, cluster, smem_bytes, m_tiles) || m_tiles != p.m_tiles)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[2];
  if (!kmajor_map(&maps[0], q2, p.M, F, BM) || !kmajor_map(&maps[1], w2t, p.D, F, BN))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem<XBF16>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, cluster, stream, &attr);
  Params args = p;
  void* argv[] = {&maps[0], &maps[1], &args};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(fc2_postln_kernel<XBF16>), argv);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace pln
}  // namespace nova

// The clusters of `cluster` blocks of the fc2 kernel that the card runs at
// once (the launch plan's `clusters`), by cudaOccupancyMaxActiveClusters.
extern "C" int nova_fused_int8_mlp_postln_clusters(int cluster, int* out) {
  using namespace nova;
  *out = 0;
  if (cluster < 1 || cluster > pln::MAX_CLUSTER) return cudaErrorInvalidValue;
  int n[2] = {0, 0};
  cudaError_t err = pln::set_smem<false>();
  if (err == cudaSuccess) err = pln::set_smem<true>();
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pln::cluster_config(cluster, cluster, nullptr, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &n[0], reinterpret_cast<const void*>(pln::fc2_postln_kernel<false>), &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &n[1], reinterpret_cast<const void*>(pln::fc2_postln_kernel<true>), &cfg);
  if (err != cudaSuccess) return err;
  *out = n[0] < n[1] ? n[0] : n[1];
  return cudaSuccess;
}

extern "C" int nova_fused_int8_mlp_postln(
    const void* x, int x_bf16, int M, int D, int F,
    const void* b1, const void* b2, const void* ln_w, const void* ln_b, int vec_bf16,
    float ln_eps, const int8_t* w1t, const float* s1, const int8_t* w2t, const float* s2,
    const float* a_x, const float* a_gelu,
    int8_t* q1, float* sx1, int8_t* q2, float* mid, float* sx2,
    void* y, int grid1, int smem1, int grid2, int cluster, int smem2, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool static_acts = a_x != nullptr;
  if (static_acts != (a_gelu != nullptr)) return cudaErrorInvalidValue;
  if (!static_acts && mid == nullptr) return cudaErrorInvalidValue;
  int n_tiles, tiles, m_tiles;
  if (!wg8::plan(M, F, D, grid1, smem1, n_tiles, tiles) ||
      !pln::plan(M, D, F, grid2, cluster, smem2, m_tiles))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_row_quant(x, x_bf16, M, D, nullptr, nullptr, 0, a_x, q1, sx1,
                                     stream);
  if (err != cudaSuccess) return err;

  EpiParams e1 = {};
  e1.sx_rows = sx1;
  e1.w_scale = s1;
  e1.bias = b1;
  e1.bias_bf16 = vec_bf16;
  if (static_acts) {
    e1.out_amax = a_gelu;
    e1.out = q2;
    err = wg8::launch<EPI_GELU_Q8>(q1, w1t, M, F, D, e1, grid1, smem1, stream);
    if (err != cudaSuccess) return err;
  } else {
    e1.out = mid;
    err = wg8::launch<EPI_GELU_F32>(q1, w1t, M, F, D, e1, grid1, smem1, stream);
    if (err != cudaSuccess) return err;
    err = launch_row_quant(mid, 0, M, F, nullptr, nullptr, 0, nullptr, q2, sx2, stream);
    if (err != cudaSuccess) return err;
  }

  pln::Params p = {};
  p.sa_rows = static_acts ? nullptr : sx2;
  p.sa_amax = a_gelu;
  p.w_scale = s2;
  p.bias = b2;
  p.ln_w = ln_w;
  p.ln_b = ln_b;
  p.vec_bf16 = vec_bf16;
  p.eps = ln_eps;
  p.x = x;
  p.y = y;
  p.M = M;
  p.D = D;
  p.m_tiles = m_tiles;
  p.ktiles = F / wg8::BK;
  return x_bf16 ? pln::launch<true>(q2, w2t, F, p, grid2, cluster, smem2, stream)
                : pln::launch<false>(q2, w2t, F, p, grid2, cluster, smem2, stream);
}
