// Flash attention, backward, for Hopper (sm_90a).
//
// Replaces the two backward Pallas TPU kernels of flash_attention
// (nova_pointcloud_tpu/ops/pallas/flash_attention.py, _flash_bwd: the dK/dV
// kernel at the pallas_call of _bwd_dkv_kernel and the dQ kernel at the
// pallas_call of _bwd_dq_kernel), the standard flash recomputation from the
// forward's saved log-sum-exp:
//
//   p     = exp(q k^T / sqrt(d) + bias - lse)      (recomputed, never stored)
//   dv    = p^T do
//   ds    = p * (do v^T - delta) / sqrt(d),  delta = sum(do * o) per row
//   dk    = ds^T q,   dq = ds k                   f32 sums, in the input dtype
//
// lse is the natural-log row log-sum-exp the forward kernel saves (1e30 on a
// row whose keys are all masked, so its p is 0 and its gradients 0); delta is
// one f32 row sum the wrapper computes from the saved output o (as the JAX
// function does in XLA). The wrapper hands both over as (B*H, Lq_pad) rows
// padded to a multiple of 128 (lse 1e30, delta 0 on the padding), so query
// tiles load them whole. bias: none, a key bias (B, Lk) read with the batch
// index bh / H, or a full bias (Lq, Lk); -inf entries give p = 0. Biases get
// no gradient (the JAX VJP declares their cotangent zero).
//
// Two kernels without atomics, as the TPU splits the work:
//   dK/dV: one block per (batch*head, 64-key tile); the block's K and V rows
//          stay in registers as mma A fragments (4 warps x 16 keys); query
//          tiles of 64 rows (q, do, lse, delta) stream through a
//          double-buffered cp.async ring, and each warp accumulates its 16
//          rows of dk and dv in f32.
//   dQ:    one block per (batch*head, 128-query tile), the forward kernel's
//          tiling: q and do fragments in registers (8 warps x 16 rows), K and
//          V tiles of 64 keys through a double-buffered cp.async ring, dq in
//          f32 registers.
// All products run on tensor cores (mma.sync m16n8k16 bf16, f32
// accumulators); p and ds are rounded to bf16 where they are the A operand
// of the next product (p^T do, ds^T q), as the forward rounds p; for ds k,
// ds goes in as two bf16 terms (hi + lo): a row of ds sums to 0, and one
// rounding would be large against dq where the keys share a common part (a
// third more products in the dQ kernel; measured on the training step, see
// PERF.md). Scores
// are kept in units of log 2 (one ex2 a probability), lse converted to them.
// f32 inputs take SIMT kernels (one thread per query row for dQ, per key row
// for dK/dV), written for exactness, not speed.
//
// q, k, v, do, dq, dk, dv are (B, H, L, d) views given by their batch / head /
// row strides with d contiguous (16-byte aligned), so the model's
// (B, L, H, d) layouts are read and written in place. Ragged tails: keys past
// Lk load as zeros and get p = 0; query rows past Lq load as zeros with lse
// 1e30.
//
// What bounds it on this card: operations. dK/dV does 8*B*H*Lq*Lk*d FLOPs
// (s, p^T do, do v^T, ds^T q), dQ 6*B*H*Lq*Lk*d (s, do v^T, ds k; the
// function's count, without the split's extra product): 0.109 and 0.081 ms
// at B*H = 128, L = 1280, d = 64 against the 989 TFLOP/s bf16 peak, against
// 0.04 ms for the bytes. A first design: no TMA, no wgmma.

#include "quant.cuh"
#include "tensor_core.cuh"

namespace nova {

constexpr float kBwdLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2b(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*H, Lqp), natural log, 1e30 on dead and padded rows
  const float* delta;  // (B*H, Lqp), 0 on padded rows
  const float* kbias;  // (B, Lk) or nullptr
  const float* fbias;  // (Lq, Lk) or nullptr
  void* dq;
  void* dk;
  void* dv;
  long q_sb, q_sh, q_sl;  // strides in elements: batch, head, row
  long k_sb, k_sh, k_sl;
  long v_sb, v_sh, v_sl;
  long o_sb, o_sh, o_sl;  // do
  long dq_sb, dq_sh, dq_sl;
  long dk_sb, dk_sh, dk_sl;
  long dv_sb, dv_sh, dv_sl;
  int H, Lq, Lk, Lqp;
  float scale;
};

constexpr int BHD = 64;       // head dim
constexpr int BLD = BHD + 8;  // padded bf16 smem row: conflict-free ldmatrix
constexpr int BKS = BHD / 16;  // k-steps over the head dim
constexpr int BDT = BHD / 8;   // n8 tiles of the head dim
constexpr int BCPR = BHD / 8;  // 16-byte chunks per row

// (a, b) as two packed bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// A fragments of 16 rows (row0, row1 = row0 + 8) x 64 of a bf16 (L, 64) view
__device__ __forceinline__ void load_a_rows(unsigned (&a)[BKS][4], const __nv_bfloat16* base,
                                            long sl, int row0, int L, int tig) {
  const int row1 = row0 + 8;
  const bool l0 = row0 < L, l1 = row1 < L;
  const __nv_bfloat16* r0 = base + static_cast<long>(l0 ? row0 : 0) * sl;
  const __nv_bfloat16* r1 = base + static_cast<long>(l1 ? row1 : 0) * sl;
#pragma unroll
  for (int ks = 0; ks < BKS; ++ks) {
    const unsigned a0 = *reinterpret_cast<const unsigned*>(r0 + ks * 16 + tig * 2);
    const unsigned a1 = *reinterpret_cast<const unsigned*>(r1 + ks * 16 + tig * 2);
    const unsigned a2 = *reinterpret_cast<const unsigned*>(r0 + ks * 16 + 8 + tig * 2);
    const unsigned a3 = *reinterpret_cast<const unsigned*>(r1 + ks * 16 + 8 + tig * 2);
    a[ks][0] = l0 ? a0 : 0u;
    a[ks][1] = l1 ? a1 : 0u;
    a[ks][2] = l0 ? a2 : 0u;
    a[ks][3] = l1 ? a3 : 0u;
  }
}

// ---------------------------------------------------------------------------
// dK/dV, bf16
// ---------------------------------------------------------------------------
constexpr int KVBK = 64;  // keys per block (4 warps x 16)
constexpr int KVBQ = 64;  // queries per streamed tile

constexpr int dkv_smem_bytes() {
  return 2 * (2 * KVBQ * BLD * static_cast<int>(sizeof(__nv_bfloat16)) +
              2 * KVBQ * static_cast<int>(sizeof(float)));
}

__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16_kernel(FlashBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TILE_BYTES = 2 * KVBQ * BLD * sizeof(__nv_bfloat16) + 2 * KVBQ * sizeof(float);

  const int nk = (p.Lk + KVBK - 1) / KVBK;
  const int kt = blockIdx.x % nk, bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* DO =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* LSE = p.lse + static_cast<long>(bh) * p.Lqp;
  const float* DEL = p.delta + static_cast<long>(bh) * p.Lqp;
  const int nq = (p.Lq + KVBQ - 1) / KVBQ;

  auto tile_q = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + buf * TILE_BYTES);
  };
  auto load_tile = [&](int buf, int qt) {
    __nv_bfloat16* Qs = tile_q(buf);
    __nv_bfloat16* Ds = Qs + KVBQ * BLD;
    float* ls = reinterpret_cast<float*>(Ds + KVBQ * BLD);
#pragma unroll
    for (int i = 0; i < KVBQ * BCPR / 128; ++i) {
      const int c = tid + i * 128, r = c / BCPR, col = (c % BCPR) * 8;
      const int row = qt * KVBQ + r;
      const bool ok = row < p.Lq;
      const long rr = ok ? row : 0;
      cp_async16(Qs + r * BLD + col, Q + rr * p.q_sl + col, ok);
      cp_async16(Ds + r * BLD + col, DO + rr * p.o_sl + col, ok);
    }
    if (tid < 2 * KVBQ / 4) {  // lse then delta, 16 chunks each (padded rows)
      const int which = tid / (KVBQ / 4), c = tid % (KVBQ / 4);
      const float* src = (which ? DEL : LSE) + qt * KVBQ + c * 4;
      cp_async16(ls + which * KVBQ + c * 4, src, true);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // this thread's two key rows (g and g + 8 of the warp's 16)
  const int key0 = kt * KVBK + warp * 16 + g, key1 = key0 + 8;
  const bool kl0 = key0 < p.Lk, kl1 = key1 < p.Lk;
  unsigned ka[BKS][4], va[BKS][4];
  load_a_rows(ka, K, p.k_sl, key0, p.Lk, tig);
  load_a_rows(va, V, p.v_sl, key0, p.Lk, tig);
  // per-key additive terms in units of log 2; a key past Lk is masked
  float kb0 = kl0 ? 0.0f : -INFINITY, kb1 = kl1 ? 0.0f : -INFINITY;
  if (p.kbias != nullptr) {
    const float* kb = p.kbias + static_cast<long>(b) * p.Lk;
    if (kl0) kb0 = kb[key0] * kBwdLog2e;
    if (kl1) kb1 = kb[key1] * kBwdLog2e;
  }
  const float scale2 = p.scale * kBwdLog2e;

  float dk[BDT][4], dv[BDT][4];
#pragma unroll
  for (int nt = 0; nt < BDT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dk[nt][i] = 0.0f;
      dv[nt][i] = 0.0f;
    }
  // ldmatrix lanes: [n][k] tiles (rows n, k contiguous) as B of two n8
  // tiles; [k][n] tiles (rows k, n contiguous) as B, transposed on load
  const int n_row = (lane & 7) + (lane >> 4) * 8, n_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;

  for (int qt = 0; qt < nq; ++qt) {
    cp_async_wait<0>();
    __syncthreads();  // tile qt landed; everyone is done with tile qt - 1
    if (qt + 1 < nq) load_tile((qt + 1) & 1, qt + 1);
    cp_async_commit();
    const __nv_bfloat16* Qs = tile_q(qt & 1);
    const __nv_bfloat16* Ds = Qs + KVBQ * BLD;
    const float* ls = reinterpret_cast<const float*>(Ds + KVBQ * BLD);
    const float* ds_ = ls + KVBQ;

    // s^T = K Q^T: 16 keys x 64 queries per warp
    float st[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < BKS; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        unsigned r[4];
        ldmatrix_x4(r, Qs + (nt * 8 + n_row) * BLD + ks * 16 + n_col);
        mma_bf16(st[nt], ka[ks], r);
        mma_bf16(st[nt + 1], ka[ks], r + 2);
      }
    // p^T = 2^(s scale2 + bias2 - lse2): rows keys, columns queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = nt * 8 + tig * 2 + c;
        const float l2 = ls[qc] * kBwdLog2e;
        float a = fmaf(st[nt][c], scale2, kb0), e = fmaf(st[nt][2 + c], scale2, kb1);
        if (p.fbias != nullptr) {
          const int qrow = qt * KVBQ + qc;
          if (qrow < p.Lq) {
            const float* fr = p.fbias + static_cast<long>(qrow) * p.Lk;
            if (kl0) a += fr[key0] * kBwdLog2e;
            if (kl1) e += fr[key1] * kBwdLog2e;
          }
        }
        st[nt][c] = ex2b(a - l2);
        st[nt][2 + c] = ex2b(e - l2);
      }
    // dv += p^T do: p^T's C fragments are A fragments (k = queries)
#pragma unroll
    for (int j = 0; j < KVBQ / 16; ++j) {
      const unsigned pa[4] = {pack_bf16(st[2 * j][0], st[2 * j][1]),
                              pack_bf16(st[2 * j][2], st[2 * j][3]),
                              pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]),
                              pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3])};
#pragma unroll
      for (int nt = 0; nt < BDT; nt += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Ds + (j * 16 + t_row) * BLD + nt * 8 + t_col);
        mma_bf16(dv[nt], pa, r);
        mma_bf16(dv[nt + 1], pa, r + 2);
      }
    }
    // dp^T = V do^T
    float dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < BKS; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        unsigned r[4];
        ldmatrix_x4(r, Ds + (nt * 8 + n_row) * BLD + ks * 16 + n_col);
        mma_bf16(dp[nt], va[ks], r);
        mma_bf16(dp[nt + 1], va[ks], r + 2);
      }
    // ds^T = p^T (dp^T - delta) scale
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dl = ds_[nt * 8 + tig * 2 + c];
        dp[nt][c] = st[nt][c] * (dp[nt][c] - dl) * p.scale;
        dp[nt][2 + c] = st[nt][2 + c] * (dp[nt][2 + c] - dl) * p.scale;
      }
    // dk += ds^T q
#pragma unroll
    for (int j = 0; j < KVBQ / 16; ++j) {
      const unsigned da[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int nt = 0; nt < BDT; nt += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Qs + (j * 16 + t_row) * BLD + nt * 8 + t_col);
        mma_bf16(dk[nt], da, r);
        mma_bf16(dk[nt + 1], da, r + 2);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* DK = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* DV = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int nt = 0; nt < BDT; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (kl0) {
      *reinterpret_cast<__nv_bfloat162*>(DK + static_cast<long>(key0) * p.dk_sl + col) =
          __floats2bfloat162_rn(dk[nt][0], dk[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(DV + static_cast<long>(key0) * p.dv_sl + col) =
          __floats2bfloat162_rn(dv[nt][0], dv[nt][1]);
    }
    if (kl1) {
      *reinterpret_cast<__nv_bfloat162*>(DK + static_cast<long>(key1) * p.dk_sl + col) =
          __floats2bfloat162_rn(dk[nt][2], dk[nt][3]);
      *reinterpret_cast<__nv_bfloat162*>(DV + static_cast<long>(key1) * p.dv_sl + col) =
          __floats2bfloat162_rn(dv[nt][2], dv[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ, bf16
// ---------------------------------------------------------------------------
constexpr int QBQ = 128;  // query rows per block (8 warps x 16)
constexpr int QBK = 64;   // keys per streamed tile

constexpr int dq_smem_bytes() {
  return 2 * 2 * QBK * BLD * static_cast<int>(sizeof(__nv_bfloat16));
}

__global__ void __launch_bounds__(256) flash_bwd_dq_bf16_kernel(FlashBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int nq = (p.Lq + QBQ - 1) / QBQ;
  const int qt = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* DO =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const int ntiles = (p.Lk + QBK - 1) / QBK;

  auto load_tile = [&](int buf, int kt) {
    __nv_bfloat16* Ks = smem + buf * 2 * QBK * BLD;
    __nv_bfloat16* Vs = Ks + QBK * BLD;
#pragma unroll
    for (int i = 0; i < QBK * BCPR / 256; ++i) {
      const int c = tid + i * 256, r = c / BCPR, col = (c % BCPR) * 8;
      const int key = kt * QBK + r;
      const bool ok = key < p.Lk;
      const long kr = ok ? key : 0;
      cp_async16(Ks + r * BLD + col, K + kr * p.k_sl + col, ok);
      cp_async16(Vs + r * BLD + col, V + kr * p.v_sl + col, ok);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  const int row0 = qt * QBQ + warp * 16 + g, row1 = row0 + 8;
  const bool live0 = row0 < p.Lq, live1 = row1 < p.Lq;
  unsigned qa[BKS][4], oa[BKS][4];
  load_a_rows(qa, Q, p.q_sl, row0, p.Lq, tig);
  load_a_rows(oa, DO, p.o_sl, row0, p.Lq, tig);
  const float* LSE = p.lse + static_cast<long>(bh) * p.Lqp;
  const float* DEL = p.delta + static_cast<long>(bh) * p.Lqp;
  // rows past Lq read the padding (lse 1e30, delta 0): p = 0
  const float l20 = LSE[row0] * kBwdLog2e, l21 = LSE[row1] * kBwdLog2e;
  const float dl0 = DEL[row0], dl1 = DEL[row1];
  const float* kb = p.kbias != nullptr ? p.kbias + static_cast<long>(b) * p.Lk : nullptr;
  const float* fb0 =
      p.fbias != nullptr ? p.fbias + static_cast<long>(live0 ? row0 : 0) * p.Lk : nullptr;
  const float* fb1 =
      p.fbias != nullptr ? p.fbias + static_cast<long>(live1 ? row1 : 0) * p.Lk : nullptr;
  const float scale2 = p.scale * kBwdLog2e;

  float dq[BDT][4];
#pragma unroll
  for (int nt = 0; nt < BDT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[nt][i] = 0.0f;
  const int n_row = (lane & 7) + (lane >> 4) * 8, n_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < ntiles) load_tile((kt + 1) & 1, kt + 1);
    cp_async_commit();
    const __nv_bfloat16* Ks = smem + (kt & 1) * 2 * QBK * BLD;
    const __nv_bfloat16* Vs = Ks + QBK * BLD;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = 0.0f;
        dp[nt][i] = 0.0f;
      }
#pragma unroll
    for (int ks = 0; ks < BKS; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        unsigned r[4];
        ldmatrix_x4(r, Ks + (nt * 8 + n_row) * BLD + ks * 16 + n_col);
        mma_bf16(s[nt], qa[ks], r);
        mma_bf16(s[nt + 1], qa[ks], r + 2);
        ldmatrix_x4(r, Vs + (nt * 8 + n_row) * BLD + ks * 16 + n_col);
        mma_bf16(dp[nt], oa[ks], r);
        mma_bf16(dp[nt + 1], oa[ks], r + 2);
      }
    const bool bare = kb == nullptr && fb0 == nullptr && (kt + 1) * QBK <= p.Lk;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = kt * QBK + nt * 8 + tig * 2 + c;
        float a = fmaf(s[nt][c], scale2, -l20), e = fmaf(s[nt][2 + c], scale2, -l21);
        if (!bare) {
          if (key < p.Lk) {
            if (kb != nullptr) {
              const float kv = kb[key] * kBwdLog2e;
              a += kv;
              e += kv;
            }
            if (fb0 != nullptr) {
              a += fb0[key] * kBwdLog2e;
              e += fb1[key] * kBwdLog2e;
            }
          } else {
            a = -INFINITY;
            e = -INFINITY;
          }
        }
        const float p0 = ex2b(a), p1 = ex2b(e);
        dp[nt][c] = p0 * (dp[nt][c] - dl0) * p.scale;
        dp[nt][2 + c] = p1 * (dp[nt][2 + c] - dl1) * p.scale;
      }
    // dq += ds k: ds's C fragments are A fragments (k = keys). A row of ds
    // sums to 0, so dq is the small rest of keys that share a large common
    // part, and one bf16 rounding of ds would be large against it: ds goes
    // in as two bf16 terms, hi + lo (~16 bits), one more product on the
    // same K fragments
#pragma unroll
    for (int j = 0; j < QBK / 16; ++j) {
      unsigned hi[4], lo[4];
      split_bf16(dp[2 * j][0], dp[2 * j][1], hi[0], lo[0]);
      split_bf16(dp[2 * j][2], dp[2 * j][3], hi[1], lo[1]);
      split_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nt = 0; nt < BDT; nt += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, Ks + (j * 16 + t_row) * BLD + nt * 8 + t_col);
        mma_bf16(dq[nt], hi, r);
        mma_bf16(dq[nt + 1], hi, r + 2);
        mma_bf16(dq[nt], lo, r);
        mma_bf16(dq[nt + 1], lo, r + 2);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* DQ = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int nt = 0; nt < BDT; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (live0)
      *reinterpret_cast<__nv_bfloat162*>(DQ + static_cast<long>(row0) * p.dq_sl + col) =
          __floats2bfloat162_rn(dq[nt][0], dq[nt][1]);
    if (live1)
      *reinterpret_cast<__nv_bfloat162*>(DQ + static_cast<long>(row1) * p.dq_sl + col) =
          __floats2bfloat162_rn(dq[nt][2], dq[nt][3]);
  }
}

// ---------------------------------------------------------------------------
// f32 inputs: SIMT, exact f32 sums in the JAX kernels' formulas
// ---------------------------------------------------------------------------
constexpr int FQ = 128;  // dQ: query rows per block, one per thread
constexpr int FK = 32;   // dQ: keys per shared-memory tile
constexpr int FKV = 64;  // dK/dV: key rows per block, one per thread
constexpr int FQT = 32;  // dK/dV: queries per shared-memory tile

__global__ void __launch_bounds__(FQ) flash_bwd_dq_f32_kernel(FlashBwdParams p) {
  __shared__ __align__(16) float Ks[FK][BHD];
  __shared__ __align__(16) float Vs[FK][BHD];
  const int nq = (p.Lq + FQ - 1) / FQ;
  const int qt = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x;
  const int row = qt * FQ + tid;
  const bool live = row < p.Lq;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* DO = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;

  float q[BHD], od[BHD], dq[BHD];
  {
    const float4* qr = reinterpret_cast<const float4*>(Q + static_cast<long>(live ? row : 0) * p.q_sl);
    const float4* orr =
        reinterpret_cast<const float4*>(DO + static_cast<long>(live ? row : 0) * p.o_sl);
#pragma unroll
    for (int d = 0; d < BHD / 4; ++d) {
      const float4 a = live ? qr[d] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 c = live ? orr[d] : make_float4(0.f, 0.f, 0.f, 0.f);
      q[4 * d] = a.x * p.scale;  // q * sm_scale, as the TPU kernel
      q[4 * d + 1] = a.y * p.scale;
      q[4 * d + 2] = a.z * p.scale;
      q[4 * d + 3] = a.w * p.scale;
      od[4 * d] = c.x;
      od[4 * d + 1] = c.y;
      od[4 * d + 2] = c.z;
      od[4 * d + 3] = c.w;
    }
  }
#pragma unroll
  for (int d = 0; d < BHD; ++d) dq[d] = 0.0f;
  const float lse = p.lse[static_cast<long>(bh) * p.Lqp + row];
  const float dl = p.delta[static_cast<long>(bh) * p.Lqp + row];
  const float* kb = p.kbias != nullptr ? p.kbias + static_cast<long>(b) * p.Lk : nullptr;
  const float* fb =
      p.fbias != nullptr ? p.fbias + static_cast<long>(live ? row : 0) * p.Lk : nullptr;

  const int ntiles = (p.Lk + FK - 1) / FK;
  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();
    for (int c = tid; c < FK * BHD / 4; c += FQ) {
      const int r = c / (BHD / 4), col = (c % (BHD / 4)) * 4;
      const int key = kt * FK + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < p.Lk) {
        kv = *reinterpret_cast<const float4*>(K + static_cast<long>(key) * p.k_sl + col);
        vv = *reinterpret_cast<const float4*>(V + static_cast<long>(key) * p.v_sl + col);
      }
      *reinterpret_cast<float4*>(&Ks[r][col]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][col]) = vv;
    }
    __syncthreads();
    for (int j = 0; j < FK; ++j) {
      const int key = kt * FK + j;
      if (key >= p.Lk) break;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int d = 0; d < BHD; ++d) {
        s += q[d] * Ks[j][d];
        dp += od[d] * Vs[j][d];
      }
      if (kb != nullptr) s += kb[key];
      if (fb != nullptr) s += fb[key];
      const float pr = expf(s - lse);
      const float ds = pr * (dp - dl) * p.scale;
#pragma unroll
      for (int d = 0; d < BHD; ++d) dq[d] += ds * Ks[j][d];
    }
  }
  if (!live) return;
  float* DQ = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + static_cast<long>(row) * p.dq_sl;
#pragma unroll
  for (int d = 0; d < BHD / 4; ++d)
    reinterpret_cast<float4*>(DQ)[d] =
        make_float4(dq[4 * d], dq[4 * d + 1], dq[4 * d + 2], dq[4 * d + 3]);
}

// one thread per key row: k, dk, dv in registers, the block's v rows in
// shared memory (padded rows, conflict-free), query tiles read by broadcast
__global__ void __launch_bounds__(FKV) flash_bwd_dkv_f32_kernel(FlashBwdParams p) {
  __shared__ float Vown[FKV][BHD + 1];
  __shared__ __align__(16) float Qs[FQT][BHD];
  __shared__ __align__(16) float Ds[FQT][BHD];
  __shared__ float ls[FQT], dls[FQT];
  const int nk = (p.Lk + FKV - 1) / FKV;
  const int kt = blockIdx.x % nk, bh = blockIdx.x / nk;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x;
  const int key = kt * FKV + tid;
  const bool live = key < p.Lk;
  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* DO = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* LSE = p.lse + static_cast<long>(bh) * p.Lqp;
  const float* DEL = p.delta + static_cast<long>(bh) * p.Lqp;

  float k[BHD], dk[BHD], dv[BHD];
  {
    const float4* kr = reinterpret_cast<const float4*>(K + static_cast<long>(live ? key : 0) * p.k_sl);
    const float4* vr = reinterpret_cast<const float4*>(V + static_cast<long>(live ? key : 0) * p.v_sl);
#pragma unroll
    for (int d = 0; d < BHD / 4; ++d) {
      const float4 a = live ? kr[d] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 c = live ? vr[d] : make_float4(0.f, 0.f, 0.f, 0.f);
      k[4 * d] = a.x;
      k[4 * d + 1] = a.y;
      k[4 * d + 2] = a.z;
      k[4 * d + 3] = a.w;
      Vown[tid][4 * d] = c.x;
      Vown[tid][4 * d + 1] = c.y;
      Vown[tid][4 * d + 2] = c.z;
      Vown[tid][4 * d + 3] = c.w;
    }
  }
#pragma unroll
  for (int d = 0; d < BHD; ++d) {
    dk[d] = 0.0f;
    dv[d] = 0.0f;
  }
  const float kbv = (p.kbias != nullptr && live) ? p.kbias[static_cast<long>(b) * p.Lk + key] : 0.0f;

  const int ntiles = (p.Lq + FQT - 1) / FQT;
  for (int qt = 0; qt < ntiles; ++qt) {
    __syncthreads();
    for (int c = tid; c < FQT * BHD / 4; c += FKV) {
      const int r = c / (BHD / 4), col = (c % (BHD / 4)) * 4;
      const int row = qt * FQT + r;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), ov = qv;
      if (row < p.Lq) {
        qv = *reinterpret_cast<const float4*>(Q + static_cast<long>(row) * p.q_sl + col);
        ov = *reinterpret_cast<const float4*>(DO + static_cast<long>(row) * p.o_sl + col);
      }
      *reinterpret_cast<float4*>(&Qs[r][col]) = qv;
      *reinterpret_cast<float4*>(&Ds[r][col]) = ov;
    }
    if (tid < FQT) {
      ls[tid] = LSE[qt * FQT + tid];  // padded rows: 1e30
      dls[tid] = DEL[qt * FQT + tid];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < FQT; ++i) {
      const int row = qt * FQT + i;
      if (row >= p.Lq) break;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int d = 0; d < BHD; ++d) {
        s += Qs[i][d] * p.scale * k[d];
        dp += Ds[i][d] * Vown[tid][d];
      }
      s += kbv;
      if (p.fbias != nullptr) s += p.fbias[static_cast<long>(row) * p.Lk + key];
      const float pr = expf(s - ls[i]);
      const float ds = pr * (dp - dls[i]) * p.scale;
#pragma unroll
      for (int d = 0; d < BHD; ++d) {
        dv[d] += pr * Ds[i][d];
        dk[d] += ds * Qs[i][d];
      }
    }
  }
  if (!live) return;
  float* DK = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh + static_cast<long>(key) * p.dk_sl;
  float* DV = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh + static_cast<long>(key) * p.dv_sl;
#pragma unroll
  for (int d = 0; d < BHD / 4; ++d) {
    reinterpret_cast<float4*>(DK)[d] =
        make_float4(dk[4 * d], dk[4 * d + 1], dk[4 * d + 2], dk[4 * d + 3]);
    reinterpret_cast<float4*>(DV)[d] =
        make_float4(dv[4 * d], dv[4 * d + 1], dv[4 * d + 2], dv[4 * d + 3]);
  }
}

inline bool fill_params(FlashBwdParams& p, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta, int B, int H,
                        int Lq, int Lk, int Lqp, int D, const long* strides,
                        const float* kbias, const float* fbias, float scale, void* dq,
                        void* dk, void* dv) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || D != BHD) return false;
  if (Lqp < Lq || Lqp % QBQ != 0) return false;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.kbias = kbias;
  p.fbias = fbias;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  long* s[21] = {&p.q_sb,  &p.q_sh,  &p.q_sl,  &p.k_sb,  &p.k_sh,  &p.k_sl,  &p.v_sb,
                 &p.v_sh,  &p.v_sl,  &p.o_sb,  &p.o_sh,  &p.o_sl,  &p.dq_sb, &p.dq_sh,
                 &p.dq_sl, &p.dk_sb, &p.dk_sh, &p.dk_sl, &p.dv_sb, &p.dv_sh, &p.dv_sl};
  for (int i = 0; i < 21; ++i) *s[i] = strides[i];
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Lqp = Lqp;
  p.scale = scale;
  return true;
}

}  // namespace nova

// strides: 21 element strides, (batch, head, row) of q, k, v, do, dq, dk, dv
// in turn. lse and delta: (B*H, Lqp) f32, Lqp a multiple of 128 >= Lq.
extern "C" int nova_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, int is_bf16, int B, int H, int Lq, int Lk, int Lqp, int D,
    const long* strides, const float* kbias, const float* fbias, float scale, void* dq,
    void* dk, void* dv, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  FlashBwdParams p;
  if (!fill_params(p, q, k, v, dout, lse, delta, B, H, Lq, Lk, Lqp, D, strides, kbias, fbias,
                   scale, dq, dk, dv))
    return cudaErrorInvalidValue;
  const long bh = static_cast<long>(B) * H;
  if (is_bf16) {
    const long blocks = bh * ((Lk + KVBK - 1) / KVBK);
    if (blocks > 2147483647L) return cudaErrorInvalidValue;
    constexpr int smem = dkv_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_bf16_kernel<<<static_cast<unsigned>(blocks), 128, smem, stream>>>(p);
    return cudaGetLastError();
  }
  const long blocks = bh * ((Lk + FKV - 1) / FKV);
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  flash_bwd_dkv_f32_kernel<<<static_cast<unsigned>(blocks), FKV, 0, stream>>>(p);
  return cudaGetLastError();
}

extern "C" int nova_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, int is_bf16, int B, int H, int Lq, int Lk, int Lqp, int D,
    const long* strides, const float* kbias, const float* fbias, float scale, void* dq,
    void* dk, void* dv, void* stream_ptr) {
  using namespace nova;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  FlashBwdParams p;
  if (!fill_params(p, q, k, v, dout, lse, delta, B, H, Lq, Lk, Lqp, D, strides, kbias, fbias,
                   scale, dq, dk, dv))
    return cudaErrorInvalidValue;
  const long bh = static_cast<long>(B) * H;
  if (is_bf16) {
    const long blocks = bh * ((Lq + QBQ - 1) / QBQ);
    if (blocks > 2147483647L) return cudaErrorInvalidValue;
    constexpr int smem = dq_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<<<static_cast<unsigned>(blocks), 256, smem, stream>>>(p);
    return cudaGetLastError();
  }
  const long blocks = bh * ((Lq + FQ - 1) / FQ);
  if (blocks > 2147483647L) return cudaErrorInvalidValue;
  flash_bwd_dq_f32_kernel<<<static_cast<unsigned>(blocks), FQ, 0, stream>>>(p);
  return cudaGetLastError();
}
