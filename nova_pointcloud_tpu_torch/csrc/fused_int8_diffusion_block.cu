// One AdaLN-zero diffusion-head block, int8 serving path, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_int8_diffusion_block
// (nova_pointcloud_tpu/ops/pallas/fused_block.py, _diffusion_block_kernel):
//
//   (scale | shift | gate) = q8(silu(zc)) @ Ws * sz * ss + bs      (M, 3D)
//   h = LN(x) * (1 + scale) + shift                                LN eps 1e-6, no affine
//   a = silu(q8(h) @ W1 * sh * s1 + b1)
//   o = q8(a) @ W2 * sa * s2 + b2
//   y = (LN(o) * n2_w + n2_b) * gate + x                           norm2 eps from the caller
//
// with the three quant sites static (calibrated a_z / a_h / a_silu) or per
// row. Weights come K-major: wst (3D, D), w1t (D, D), w2t (D, D) row-major.
//
// What bounds it on this card: bytes. The three int8 weights are 5*D*D bytes
// (5.2 MB at D=1024, 1.6 us at 3.35 TB/s); at the serving shape (M = 200 rows:
// batch 4 x CFG 2 x 25 predicted tokens) the products are 2.1 GOP (1.1 us at
// the int8 peak). No phase fills the card, and the head calls it 9450 times
// a t2i call, so what it costs is launches and the gaps between them.
//
// Design: one persistent launch, at most one block an SM, walking the phases
// with a grid-wide barrier between two phases where the second needs whole
// rows of the first:
//   P1  rows: silu(zc) -> int8 qz; x's mean and 1/std (the AdaLN's LN),
//       half the warps each
//   P2  stats GEMM; its epilogue holds scale, shift and gate of the same
//       (row, column) in one thread (the block takes the columns c, D + c,
//       2D + c of its groups), so it writes gate and h = LN(x) (1 + scale)
//       + shift itself: static, h quantized to int8 qh element by element;
//       per row, h in f32
//   P3  rows (per row only): h -> int8 qh with its row scale
//   P4  fc1 GEMM, silu epilogue: static, int8 qa; per row, f32
//   P4b rows (per row only): silu(a) -> int8 qa with its row scale
//   P5  fc2 GEMM -> o (f32)
//   P6  rows: y = LN(o) n2 * gate + x
// so four barriers on the static path and six per row. Each GEMM phase
// splits the output columns over the blocks in units of gpb <= 2 groups of
// 8 and, where the units still cover the columns, the rows into two parts
// (at D = 1024 and 200 rows: 64 units of 2 groups x 2 parts of 112 rows,
// 128 blocks), so each block streams half the activations; the block's
// weight rows of all three products (5 gpb 8 rows of D bytes) are
// bulk-copied into shared memory at the start, so they arrive while P1
// runs, and its column scales and biases are staged beside them; the
// activations (M x D int8) stream through a 4-stage cp.async ring in
// 128-row chunks, and the products run on mma.sync m16n8k32 (at 200 rows
// they are 1.1 us at the int8 peak: the tensor cores are not what bounds
// it), a step's fragments loaded before its products. Each epilogue loads
// what it needs for all its elements before it computes any. The row
// phases give each block a share of the rows, one warp a row, through
// quant.cuh's row_op with 16 loads in flight a thread. With x, zc and the
// vectors all bf16 (the serving case) every load's type is known at
// compile time. The intermediates live in one workspace in device memory
// (offsets: layout() below, and fused_block.diffusion_plan on the Python
// side). What the time is spent on (PERF.md): not bytes or
// operations but the chain of dependent steps, about 5-9 us a phase.
//
// The grid barrier is a counter in device memory that each barrier leaves
// at 0 and a generation that only grows, so no launch resets it and the
// kernel replays from a CUDA graph; a block that waits too long traps (a
// launch error, not a hung card). Launches of this kernel must not overlap
// (one stream, as the pipelines run it); the grid is at most the blocks
// that fit on the card at once, checked at the launch.

#include "hopper.cuh"
#include "int8_epilogue.cuh"
#include "tensor_core.cuh"

namespace nova {
namespace dfb {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int RC = 16 * WARPS;   // rows of a GEMM row chunk: an m16 tile a warp
constexpr int BK = 128;          // bytes of k a ring stage holds
constexpr int ALD = BK + 16;     // padded staged row: ldmatrix without bank conflicts
constexpr int ASTAGES = 4;
constexpr int A_STAGE = RC * ALD;
constexpr int MAXG = 2;          // 8-column groups a block
constexpr int NCV = 10;          // per-column vectors: ss (3 parts), bs (3), s1, b1, s2, b2
constexpr int RU = 16;           // loads in flight a thread in the row passes
constexpr int SMEM_LIMIT = 232448;
constexpr int WS_ALIGN = 256;
constexpr int N_WS = 11;         // workspace arrays

struct Params {
  const void* x;
  const void* zc;
  int x_bf16, zc_bf16, M, D;
  const void* bs;
  const void* b1;
  const void* b2;
  const void* n2_w;
  const void* n2_b;
  int vec_bf16;
  float n2_eps;
  const int8_t* wst;
  const float* ss;
  const int8_t* w1t;
  const float* s1;
  const int8_t* w2t;
  const float* s2;
  const float* a_z;
  const float* a_h;
  const float* a_silu;
  int8_t *qz, *qh, *qa;
  float *sz, *sh, *sa, *mu, *rstd, *gate, *o, *mid;
  void* y;
  int gpb, parts, part_rows, w_ld, off_a, off_bar, off_cv;
};

inline long align_up(long v, long a) { return (v + a - 1) / a * a; }

// The launch plan. The grid's blocks split the output columns of each
// product into column units of gpb groups of 8, and, when the units still
// cover every group with parts = 2, the rows into two parts of part_rows
// (a multiple of 16), so that a block streams half the activations; block b
// takes column unit b / parts and row part b % parts. Shared memory: the
// weight slabs (5 gpb 8 rows of D + 16 bytes), the activation ring (which
// the row phases' staged rows share), three mbarriers, the block's column
// vectors. The workspace: qz, qh, qa (M x D int8), sz, sh, sa, mu, rstd (M
// f32), gate, o (M x D f32) and, per row only, mid (M x D f32), each at a
// 256-byte boundary. Mirrored by fused_block.diffusion_plan.
struct Layout {
  int gpb, parts, part_rows, w_ld, off_a, off_bar, off_cv, smem;
  long off[N_WS], bytes;
};

inline int layout_smem(int D, int gpb, Layout& L) {
  L.w_ld = D + 16;
  L.off_a = static_cast<int>(align_up(static_cast<long>(5 * gpb * 8) * L.w_ld, 128));
  const int a_bytes = ASTAGES * A_STAGE > WARPS * D * 4 ? ASTAGES * A_STAGE : WARPS * D * 4;
  L.off_bar = L.off_a + a_bytes;
  L.off_cv = L.off_bar + 32;
  return L.off_cv + NCV * MAXG * 8 * 4;
}

inline bool layout(int M, int D, int grid, bool per_row, Layout& L) {
  const int groups = D / 8;
  if (M <= 0 || D <= 0 || D % 128 != 0 || grid < 1 || grid > groups) return false;
  const int gpb2 = grid % 2 == 0 ? (groups + grid / 2 - 1) / (grid / 2) : MAXG + 1;
  L.parts = M >= 32 && gpb2 <= MAXG && layout_smem(D, gpb2, L) <= SMEM_LIMIT ? 2 : 1;
  L.gpb = (groups + grid / L.parts - 1) / (grid / L.parts);
  if (L.gpb > MAXG) return false;
  L.part_rows = L.parts == 1 ? M : static_cast<int>(align_up((M + 1) / 2, 16));
  L.smem = layout_smem(D, L.gpb, L);
  const long md = static_cast<long>(M) * D;
  const long size[N_WS] = {md, md, md, 4L * M, 4L * M, 4L * M, 4L * M, 4L * M,
                           4 * md, 4 * md, per_row ? 4 * md : 0};
  long end = 0;
  for (int i = 0; i < N_WS; ++i) {
    L.off[i] = size[i] ? align_up(end, WS_ALIGN) : 0;
    if (size[i]) end = L.off[i] + size[i];
  }
  L.bytes = end;
  return L.smem <= SMEM_LIMIT;
}

__device__ unsigned int g_bar_count = 0;  // blocks arrived at the open barrier
__device__ unsigned int g_bar_gen = 0;    // barriers passed, ever

// Every block's writes before the barrier are seen by every block after it.
__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned gen, now, polls = 0;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(gen) : "l"(&g_bar_gen) : "memory");
    __threadfence();
    if (atomicAdd(&g_bar_count, 1u) + 1 == gridDim.x) {
      atomicExch(&g_bar_count, 0u);  // at 0 again before anyone passes
      __threadfence();
      atomicAdd(&g_bar_gen, 1u);
    } else {
      do {
        if (++polls == (1u << 26)) __trap();
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(&g_bar_gen) : "memory");
      } while (now == gen);
    }
    __threadfence();
  }
  __syncthreads();
}

// elements i and i + 1 of an f32 or bf16 array
__device__ __forceinline__ float2 ld2_any(const void* p, long i, int bf16) {
  return bf16 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const __nv_bfloat16*>(p) + i))
              : *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
}

// x's row statistics for the AdaLN: mean and 1 / sqrt(var + 1e-6), two-pass
// as row_op's LayerNorm, one warp a row
__device__ __forceinline__ void ln_stats_row(const Params& p, int x_bf16, long row, float* srow,
                                             int lane) {
  const int D = p.D;
  const long base = row * D;
  float s = 0.0f;
  for (int k0 = lane; k0 < D; k0 += RU * 32) {
    float v[RU];
#pragma unroll
    for (int u = 0; u < RU; ++u)
      v[u] = k0 + 32 * u < D ? ld_any(p.x, base + k0 + 32 * u, x_bf16) : 0.0f;
#pragma unroll
    for (int u = 0; u < RU; ++u)
      if (k0 + 32 * u < D) {
        srow[k0 + 32 * u] = v[u];
        s += v[u];
      }
  }
  const float mu = warp_sum(s) / static_cast<float>(D);
  float d2 = 0.0f;
  for (int k = lane; k < D; k += 32) {
    const float d = srow[k] - mu;
    d2 += d * d;
  }
  const float var = warp_sum(d2) / static_cast<float>(D);
  if (lane == 0) {
    p.mu[row] = mu;
    p.rstd[row] = 1.0f / sqrtf(var + kLnEps);
  }
}

// a row pass: row_op<OP> for each of this block's rows, one warp a row
template <int OP>
__device__ __forceinline__ void row_phase(const Params& p, const RowParams& rp, float* srow) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long r = blockIdx.x + static_cast<long>(warp) * gridDim.x; r < p.M;
       r += static_cast<long>(WARPS) * gridDim.x)
    row_op<OP, 32, RU>(rp, r, srow, nullptr, lane);
}

enum { PH_STATS = 0, PH_FC1 = 1, PH_FC2 = 2 };
// the block's column vectors in shared memory: vector a, group jj, column cc
// at cv[(a MAXG + jj) 8 + cc]
enum { CV_SS = 0, CV_BS = 3, CV_S1 = 6, CV_B1 = 7, CV_S2 = 8, CV_B2 = 9 };

// One product: this block's ng groups of 8 output columns (of each of the
// three parts for the stats), from the weight slab rows at slab0 once they
// have arrived (mbarrier wbar), over rows [r0, r1) of the int8 activations
// A (M, D) in chunks of RC rows, each streamed through the ring in BK-byte
// steps of k. Warp w holds rows 16 w .. 16 w + 15 of a chunk. The
// epilogue loads what it needs for all its elements before it computes
// any, so it waits for device memory once.
template <int PH, bool STATIC, bool BF16>
__device__ __forceinline__ void gemm_phase(const Params& p, const int8_t* A, int slab0, int g0,
                                           int ng, int r0, int r1, uint32_t wbar,
                                           unsigned char* smem) {
  constexpr int NP = PH == PH_STATS ? 3 : 1;  // parts: scale, shift, gate
  if (ng == 0 || r1 <= r0) return;
  mbar_wait(wbar, 0);
  const int D = p.D, nk = D / BK, steps = ((r1 - r0 + RC - 1) / RC) * nk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int x_bf16 = BF16 ? 1 : p.x_bf16;
  int8_t* ring = reinterpret_cast<int8_t*>(smem + p.off_a);
  const float* cv = reinterpret_cast<const float*>(smem + p.off_cv);
  // step st: row chunk st / nk, k chunk st % nk, into ring slot st % ASTAGES
  auto load = [&](int st) {
    const int rc = st / nk, kc = st - rc * nk;
    int8_t* dst = ring + (st % ASTAGES) * A_STAGE;
#pragma unroll
    for (int i = 0; i < RC * (BK / 16) / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 16), col = (c % (BK / 16)) * 16;
      const int gm = r0 + rc * RC + r;
      const bool ok = gm < r1;
      cp_async16(dst + r * ALD + col, A + static_cast<long>(ok ? gm : 0) * D + kc * BK + col, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < ASTAGES - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  int acc[NP * MAXG][4];
#pragma unroll
  for (int n = 0; n < NP * MAXG; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const uint32_t wsl = smem_u32(smem);

  int rc = 0, kc = 0;
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<ASTAGES - 2>();
    __syncthreads();  // step st landed; everyone is done with step st - 1
    if (st + ASTAGES - 1 < steps) load(st + ASTAGES - 1);
    cp_async_commit();
    const int rbase = r0 + rc * RC + 16 * warp;
    if (rbase < r1) {
      // the step's fragments first, then its products (the shared-memory
      // loads and the mma.sync are volatile asm and keep their order)
      const int8_t* As = ring + (st % ASTAGES) * A_STAGE;
      unsigned af[BK / 32][4], bf[BK / 32][NP * MAXG][2];
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) {
        ldmatrix_x4(af[ks], As + (16 * warp + a_row) * ALD + 32 * ks + a_col);
#pragma unroll
        for (int q = 0; q < NP; ++q)
#pragma unroll
          for (int jj = 0; jj < MAXG; ++jj)
            if (jj < ng) {
              const uint32_t wa = wsl + ((slab0 + q * p.gpb + jj) * 8 + g) * p.w_ld + kc * BK +
                                  32 * ks + 4 * t;
              bf[ks][q * MAXG + jj][0] = lds_u32(wa);
              bf[ks][q * MAXG + jj][1] = lds_u32(wa + 16);
            }
      }
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
#pragma unroll
        for (int n = 0; n < NP * MAXG; ++n)
          if (n % MAXG < ng) mma_s8(acc[n], af[ks], bf[ks][n]);
    }
    if (kc == nk - 1 && rbase < r1) {
      // rows rbase + g + 8 half; columns 8 (g0 + jj) + 2 t and + 1
      bool in[2];
      float sx[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = rbase + g + 8 * half;
        in[half] = row < r1;
        const float* sx_rows = PH == PH_STATS ? p.sz : (PH == PH_FC1 ? p.sh : p.sa);
        const float* amax = PH == PH_STATS ? p.a_z : (PH == PH_FC1 ? p.a_h : p.a_silu);
        sx[half] = STATIC ? static_scale(amax) : (in[half] ? sx_rows[row] : 0.0f);
      }
      if constexpr (PH == PH_STATS) {
        float2 xv[MAXG][2];
        float mu[2], rstd[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = rbase + g + 8 * half;
          mu[half] = in[half] ? p.mu[row] : 0.0f;
          rstd[half] = in[half] ? p.rstd[row] : 0.0f;
#pragma unroll
          for (int jj = 0; jj < MAXG; ++jj)
            xv[jj][half] = in[half] && jj < ng
                               ? ld2_any(p.x, static_cast<long>(row) * D + (g0 + jj) * 8 + 2 * t,
                                         x_bf16)
                               : make_float2(0.0f, 0.0f);
        }
        const float inv_h = STATIC ? 1.0f / static_scale(p.a_h) : 0.0f;
#pragma unroll
        for (int jj = 0; jj < MAXG; ++jj) {
          if (jj >= ng) continue;
          const int col = (g0 + jj) * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (!in[half]) continue;
            const long o = static_cast<long>(rbase + g + 8 * half) * D + col;
            float gt[2], hv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * half + e, cc = 8 * jj + 2 * t + e;
              const float scale = static_cast<float>(acc[jj][i]) * sx[half] *
                                  cv[(CV_SS + 0) * MAXG * 8 + cc] + cv[(CV_BS + 0) * MAXG * 8 + cc];
              const float shift = static_cast<float>(acc[MAXG + jj][i]) * sx[half] *
                                  cv[(CV_SS + 1) * MAXG * 8 + cc] + cv[(CV_BS + 1) * MAXG * 8 + cc];
              gt[e] = static_cast<float>(acc[2 * MAXG + jj][i]) * sx[half] *
                      cv[(CV_SS + 2) * MAXG * 8 + cc] + cv[(CV_BS + 2) * MAXG * 8 + cc];
              float v = ((e ? xv[jj][half].y : xv[jj][half].x) - mu[half]) * rstd[half];
              hv[e] = v * (1.0f + scale) + shift;  // the AdaLN
            }
            *reinterpret_cast<float2*>(p.gate + o) = make_float2(gt[0], gt[1]);
            if (STATIC) {
              char2 q;
              q.x = q8_rint(hv[0] * inv_h);
              q.y = q8_rint(hv[1] * inv_h);
              *reinterpret_cast<char2*>(p.qh + o) = q;
            } else {
              *reinterpret_cast<float2*>(p.mid + o) = make_float2(hv[0], hv[1]);
            }
          }
        }
      } else {
        EpiParams ep = {};
        if (PH == PH_FC1) {
          ep.out_amax = p.a_silu;
          ep.out = STATIC ? static_cast<void*>(p.qa) : static_cast<void*>(p.mid);
        } else {
          ep.out = p.o;
        }
        constexpr int EPI = PH == PH_FC2 ? EPI_STORE : (STATIC ? EPI_SILU_Q8 : EPI_SILU_F32);
        constexpr int CW = PH == PH_FC1 ? CV_S1 : CV_S2, CB = PH == PH_FC1 ? CV_B1 : CV_B2;
        const float out_inv = EPI == EPI_SILU_Q8 ? epi_out_inv(ep) : 0.0f;
#pragma unroll
        for (int jj = 0; jj < MAXG; ++jj) {
          if (jj >= ng) continue;
          const int col = (g0 + jj) * 8 + 2 * t, cc = 8 * jj + 2 * t;
          const float ws[2] = {cv[CW * MAXG * 8 + cc], cv[CW * MAXG * 8 + cc + 1]};
          const float bs[2] = {cv[CB * MAXG * 8 + cc], cv[CB * MAXG * 8 + cc + 1]};
#pragma unroll
          for (int half = 0; half < 2; ++half)
            if (in[half])
              epilogue_sx<EPI>(ep, D, rbase + g + 8 * half, col, sx[half], out_inv, ws, bs,
                               acc[jj][2 * half], acc[jj][2 * half + 1], make_float2(0.0f, 0.0f));
        }
      }
    }
    if (kc == nk - 1) {
#pragma unroll
      for (int n = 0; n < NP * MAXG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0;
    }
    if (++kc == nk) {
      kc = 0;
      ++rc;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next phase
}

// BF16: x, zc and the vectors are all bfloat16 (the serving path's case), so
// every load's type is known at compile time and the row passes' loads go
// out together; else the flags decide at run time.
template <bool STATIC, bool BF16>
__global__ void __launch_bounds__(THREADS, 1) diffusion_block_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.D, groups = D / 8;
  const int unit = blockIdx.x / p.parts, part = blockIdx.x - unit * p.parts;
  const int g0 = unit * p.gpb, ng = max(0, min(p.gpb, groups - g0));
  const int r0 = part * p.part_rows, r1 = min(p.M, r0 + p.part_rows);
  const int x_bf16 = BF16 ? 1 : p.x_bf16, vec_bf16 = BF16 ? 1 : p.vec_bf16;
  const uint32_t wbar = smem_u32(smem + p.off_bar);  // stats, fc1, fc2 slabs
  float* srow = reinterpret_cast<float*>(smem + p.off_a) + warp * D;

  // the weight slabs: rows (q gpb + jj) 8 + r for the stats' part q (scale,
  // shift, gate) of group jj; (3 gpb + jj) 8 + r for fc1; (4 gpb + jj) 8 + r
  // for fc2; one bulk copy a row
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(wbar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0 && ng > 0) {
    if (lane == 0) {
      mbar_expect_tx(wbar, 3 * ng * 8 * D);
      mbar_expect_tx(wbar + 8, ng * 8 * D);
      mbar_expect_tx(wbar + 16, ng * 8 * D);
    }
    __syncwarp();
    for (int i = lane; i < 5 * ng * 8; i += 32) {
      const int slab = i / (ng * 8), r = i - slab * ng * 8, jj = r >> 3;
      const long col = (g0 + jj) * 8 + (r & 7);  // output column within its product
      const int8_t* src = slab < 3 ? p.wst + (slab * D + col) * D
                                   : (slab == 3 ? p.w1t : p.w2t) + col * D;
      const int srow_i = (slab * p.gpb + jj) * 8 + (r & 7);
      bulk_load(smem_u32(smem + static_cast<long>(srow_i) * p.w_ld), src, D,
                wbar + 8 * (slab < 3 ? 0 : slab - 2));
    }
  }
  // the block's column vectors (read after the first grid barrier)
  if (tid >= 32 && tid < 32 + NCV * MAXG * 8) {
    const int a = (tid - 32) / (MAXG * 8), r = (tid - 32) % (MAXG * 8), jj = r / 8;
    float v = 0.0f;
    if (jj < ng) {
      const int col = (g0 + jj) * 8 + r % 8;
      if (a < CV_BS)
        v = p.ss[(a - CV_SS) * D + col];
      else if (a < CV_S1)
        v = ld_any(p.bs, (a - CV_BS) * D + col, vec_bf16);
      else if (a == CV_S1 || a == CV_S2)
        v = (a == CV_S1 ? p.s1 : p.s2)[col];
      else
        v = ld_any(a == CV_B1 ? p.b1 : p.b2, col, vec_bf16);
    }
    reinterpret_cast<float*>(smem + p.off_cv)[a * MAXG * 8 + r] = v;
  }

  // P1: silu(zc) -> qz (warps 0-3), and x's row statistics (warps 4-7)
  RowParams rz = {};
  rz.x = p.zc;
  rz.x_bf16 = BF16 ? 1 : p.zc_bf16;
  rz.K = D;
  rz.amax_static = p.a_z;
  rz.q = p.qz;
  rz.sx = p.sz;
  for (long r = blockIdx.x + static_cast<long>(warp % (WARPS / 2)) * gridDim.x; r < p.M;
       r += static_cast<long>(WARPS / 2) * gridDim.x) {
    if (warp < WARPS / 2)
      row_op<ROW_SILU_QUANT, 32, RU>(rz, r, srow, nullptr, lane);
    else
      ln_stats_row(p, x_bf16, r, srow, lane);
  }
  grid_barrier();
  // P2: stats, gate, h
  gemm_phase<PH_STATS, STATIC, BF16>(p, p.qz, 0, g0, ng, r0, r1, wbar, smem);
  grid_barrier();
  RowParams rq = {};  // P3 / P4b: the per-row quant of mid
  rq.x = p.mid;
  rq.K = D;
  if (!STATIC) {
    rq.q = p.qh;
    rq.sx = p.sh;
    row_phase<ROW_QUANT>(p, rq, srow);
    grid_barrier();
  }
  // P4: fc1
  gemm_phase<PH_FC1, STATIC, BF16>(p, p.qh, 3 * p.gpb, g0, ng, r0, r1, wbar + 8, smem);
  grid_barrier();
  if (!STATIC) {
    rq.q = p.qa;
    rq.sx = p.sa;
    row_phase<ROW_QUANT>(p, rq, srow);
    grid_barrier();
  }
  // P5: fc2
  gemm_phase<PH_FC2, STATIC, BF16>(p, p.qa, 4 * p.gpb, g0, ng, r0, r1, wbar + 16, smem);
  grid_barrier();
  // P6: y = LN(o) n2 * gate + x
  RowParams ry = {};
  ry.x = p.o;
  ry.K = D;
  ry.ln_w = p.n2_w;
  ry.ln_b = p.n2_b;
  ry.vec_bf16 = vec_bf16;
  ry.eps = p.n2_eps;
  ry.mod = p.gate;
  ry.mod_ld = D;
  ry.res = p.x;
  ry.res_bf16 = x_bf16;
  ry.y = p.y;
  ry.y_bf16 = x_bf16;
  row_phase<ROW_POSTLN_GATE>(p, ry, srow);
}

// per instance (static x bf16): the dynamic shared memory set so far, and
// the blocks of the last launch's size that fit on an SM (file-scope, so
// each build of this source keeps its own)
static int g_attr_smem[4] = {0, 0, 0, 0};
static int g_occ_smem[4] = {-1, -1, -1, -1};
static int g_occ_blocks[4] = {0, 0, 0, 0};
static int g_sms = 0;

template <bool STATIC, bool BF16>
cudaError_t launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  auto kernel = diffusion_block_kernel<STATIC, BF16>;
  constexpr int I = 2 * STATIC + BF16;
  cudaError_t err;
  if (smem > g_attr_smem[I]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    g_attr_smem[I] = smem;
  }
  if (g_occ_smem[I] != smem) {
    int dev;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_occ_blocks[I], kernel, THREADS,
                                                             smem)) != cudaSuccess)
      return err;
    g_occ_smem[I] = smem;
  }
  // every block must be resident at once, or the grid barrier waits for
  // blocks that cannot start
  if (grid > g_occ_blocks[I] * g_sms) return cudaErrorCooperativeLaunchTooLarge;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dfb
}  // namespace nova

// workspace: ws_bytes at a 256-byte boundary, laid out as dfb::layout says;
// grid and smem_bytes: the caller's launch plan, checked against it.
extern "C" int nova_fused_int8_diffusion_block(
    const void* x, int x_bf16, const void* zc, int zc_bf16, int M, int D,
    const void* bs, const void* b1, const void* b2, const void* n2_w, const void* n2_b,
    int vec_bf16, float n2_eps,
    const int8_t* wst, const float* ss, const int8_t* w1t, const float* s1,
    const int8_t* w2t, const float* s2,
    const float* a_z, const float* a_h, const float* a_silu,
    void* workspace, long ws_bytes, void* y, int grid, int smem_bytes, void* stream_ptr) {
  using namespace nova;
  using namespace nova::dfb;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool static_acts = a_z != nullptr;
  if (static_acts != (a_h != nullptr) || static_acts != (a_silu != nullptr))
    return cudaErrorInvalidValue;
  const void* copied[4] = {wst, w1t, w2t, workspace};  // bulk copies: 16-byte aligned
  for (const void* w : copied)
    if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return cudaErrorInvalidValue;
  Layout L;
  if (!layout(M, D, grid, !static_acts, L) || L.smem != smem_bytes || L.bytes != ws_bytes ||
      reinterpret_cast<uintptr_t>(workspace) % WS_ALIGN != 0)
    return cudaErrorInvalidConfiguration;
  Params p;
  p.x = x;
  p.zc = zc;
  p.x_bf16 = x_bf16;
  p.zc_bf16 = zc_bf16;
  p.M = M;
  p.D = D;
  p.bs = bs;
  p.b1 = b1;
  p.b2 = b2;
  p.n2_w = n2_w;
  p.n2_b = n2_b;
  p.vec_bf16 = vec_bf16;
  p.n2_eps = n2_eps;
  p.wst = wst;
  p.ss = ss;
  p.w1t = w1t;
  p.s1 = s1;
  p.w2t = w2t;
  p.s2 = s2;
  p.a_z = a_z;
  p.a_h = a_h;
  p.a_silu = a_silu;
  char* ws = static_cast<char*>(workspace);
  p.qz = reinterpret_cast<int8_t*>(ws + L.off[0]);
  p.qh = reinterpret_cast<int8_t*>(ws + L.off[1]);
  p.qa = reinterpret_cast<int8_t*>(ws + L.off[2]);
  p.sz = reinterpret_cast<float*>(ws + L.off[3]);
  p.sh = reinterpret_cast<float*>(ws + L.off[4]);
  p.sa = reinterpret_cast<float*>(ws + L.off[5]);
  p.mu = reinterpret_cast<float*>(ws + L.off[6]);
  p.rstd = reinterpret_cast<float*>(ws + L.off[7]);
  p.gate = reinterpret_cast<float*>(ws + L.off[8]);
  p.o = reinterpret_cast<float*>(ws + L.off[9]);
  p.mid = static_acts ? nullptr : reinterpret_cast<float*>(ws + L.off[10]);
  p.y = y;
  p.gpb = L.gpb;
  p.parts = L.parts;
  p.part_rows = L.part_rows;
  p.w_ld = L.w_ld;
  p.off_a = L.off_a;
  p.off_bar = L.off_bar;
  p.off_cv = L.off_cv;
  if (x_bf16 && zc_bf16 && vec_bf16)
    return static_acts ? launch<true, true>(p, grid, smem_bytes, stream)
                       : launch<false, true>(p, grid, smem_bytes, stream);
  return static_acts ? launch<true, false>(p, grid, smem_bytes, stream)
                     : launch<false, false>(p, grid, smem_bytes, stream);
}
