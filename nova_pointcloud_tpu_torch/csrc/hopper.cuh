// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_static.cu, flash_attention_bwd.cu):
// mbarriers, TMA tensor and bulk copies, shared-memory access by 32-bit
// address, ldmatrix, named barriers, the f32 kernels' swizzled 64 x 64
// tile layout, wgmma shared-memory descriptors (128B, 64B and 32B swizzle,
// K- and MN-major; none), wgmma wrappers (bf16 m64n64k16, m64n96k16, m64n128k16
// and m64n8k16, s8 m64n96k32, m64n128k32, m64n192k32 and m64n256k32), setmaxnreg,
// thread-block clusters (ranks, distributed shared memory, remote mbarrier
// arrivals) and, on the host, the TMA map encoder reached through
// cudaGetDriverEntryPoint, so that no library links -lcuda. The int8
// GEMM (int8_wgmma.cuh), the int8 attention and post-LN MLP blocks and the
// diffusion block use them too.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <math.h>
#include <stdint.h>

namespace nova {

// 2^x by the special-function unit; ex2(-inf) = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#ifndef NOVA_PACK_BF16  // also in tensor_core.cuh / hopper.cuh: a source may include both
#define NOVA_PACK_BF16
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits until the phase of parity `parity` has completed; traps (a launch
// error, not a hung card) if it never does
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// a (c0, c1) box of a 2-D map (c0 the contiguous dimension)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// adds a 64-row x 32-float box from (128B-swizzled) shared memory into the
// f32 workspace at (col, row)
__device__ __forceinline__ void tma_reduce_add_2d(const CUtensorMap* map, uint32_t src, int col,
                                                  int row) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row)
      : "memory");
}
// adds a box from (swizzled) shared memory into an f32 4-D map at (c0, c1,
// c2, c3); what falls outside the map is not written
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// stores a box from (swizzled) shared memory into global memory at (col,
// row) by the map's layout; what falls outside the map is not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int col,
                                             int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row)
               : "memory");
}
// shared-memory loads and stores by 32-bit shared address: through a
// generic pointer the compiler emits generic ld / st, several times slower
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ unsigned lds_u32(uint32_t addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint4 lds_u4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts_u4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void sts_u32(uint32_t addr, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void sts_f4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}
// atomic add on a shared-memory word; returns the old value
__device__ __forceinline__ uint32_t atom_add_shared(uint32_t addr, uint32_t v) {
  uint32_t old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;" : "=r"(old) : "r"(addr), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// wgmma shared-memory descriptor of a 128B-swizzled tile with 128-byte rows
// (64 bf16) and 8-row groups 1024 bytes apart. K-major (the product's k
// dimension along the row): LBO unused (1). MN-major (k along the rows): one
// 64-wide swizzle atom along m / n, so LBO is never stepped; it is set to the
// same 1024 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, bool mn_major) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(mn_major ? 64 : 1) << 16;
  d |= static_cast<uint64_t>(64) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}
// the same for a K-major 64B-swizzled tile with 64-byte rows (64 int8) and
// 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(32) << 32;
  d |= static_cast<uint64_t>(2) << 62;
  return d;
}

// the same for a K-major 32B-swizzled tile with 32-byte rows (32 int8: a
// 32-column panel of a 96-wide int8 row, one s8 k-step) and 8-row groups
// 256 bytes apart
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(16) << 32;
  d |= static_cast<uint64_t>(3) << 62;
  return d;
}

// the same for an MN-major 64B-swizzled tile (the product's k dimension
// along the rows): 64-byte rows (32 bf16 of m / n) in 8-row groups 512
// bytes apart (SBO), the next 32 columns of m / n `lbo` bytes on (LBO: the
// panels of a 96-wide row)
__device__ __forceinline__ uint64_t desc_sw64_mn(uint32_t addr, int lbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(lbo >> 4) << 16;
  d |= static_cast<uint64_t>(32) << 32;
  d |= static_cast<uint64_t>(2) << 62;
  return d;
}

// the same for a tile without swizzle: 8-row x 16-byte core matrices, the
// next along k `lbo` bytes on, the next along m / n `sbo` bytes on
__device__ __forceinline__ uint64_t desc_noswizzle(uint32_t addr, int lbo, int sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(lbo >> 4) << 16;
  d |= static_cast<uint64_t>(sbo >> 4) << 32;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma uses across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define NOVA_WG_D32(c)                                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),        \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),        \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define NOVA_WG_D64(c)                                                                       \
  NOVA_WG_D32(c), c(d[32]), c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]),      \
      c(d[39]), c(d[40]), c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]),        \
      c(d[47]), c(d[48]), c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]),        \
      c(d[55]), c(d[56]), c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define NOVA_WG_REGS32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define NOVA_WG_REGS64                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// Accumulator element i of a thread of an m64nN wgmma (f32 or s32): row
// 16 warp + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1), with
// g = lane / 4 and t = lane % 4. The A fragments of a 16-bit m64k16 step
// from registers have the same layout: a[e] holds the pair of element
// 2 e of an m64n16 accumulator.

// d (64 x 64, f32) (+)= A B, both from shared memory; TA / TB: MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NOVA_WG_REGS32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : NOVA_WG_D32("+f")
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
// d (64 x 64, f32) (+)= A B, A (64 x 16 bf16) from registers, B from shared
// memory; TB: MN-major
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NOVA_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : NOVA_WG_D32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}
#define NOVA_WG_D48(c)                                                                       \
  NOVA_WG_D32(c), c(d[32]), c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]),      \
      c(d[39]), c(d[40]), c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47])
#define NOVA_WG_REGS48                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
// d (64 x 96, f32) (+)= A B, A (64 x 16 bf16) from registers, B from shared
// memory; TB: MN-major (head dim 96: p v, and the backward's products into
// dk, dv and dq)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const unsigned (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " NOVA_WG_REGS48
      ", {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : NOVA_WG_D48("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// d (64 x 128, f32) (+)= A B, A (64 x 16 bf16) and B (128 x 16 bf16) both
// K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NOVA_WG_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : NOVA_WG_D64("+f")
      : "l"(da), "l"(db), "r"(acc));
}
// d (64 x 8, f32) (+)= A B, A (64 x 16 bf16) from registers, B (K-major)
// from shared memory
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const unsigned (&a)[4], uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
// d (64 x 128, s32) (+)= A B, A (64 x 32 s8) and B (128 x 32 s8), both
// K-major in shared memory (the only layout of 8-bit wgmma)
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " NOVA_WG_REGS64
      ", %64, %65, p;\n}\n"
      : NOVA_WG_D64("+r")
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 256, s32) (+)= A B, A (64 x 32 s8) and B (256 x 32 s8), both
// K-major in shared memory
#define NOVA_WG_D128(c) NOVA_WG_D64(c), c(d[64]), c(d[65]), c(d[66]), c(d[67]), c(d[68]), \
      c(d[69]), c(d[70]), c(d[71]), c(d[72]), c(d[73]), c(d[74]), c(d[75]), c(d[76]), \
      c(d[77]), c(d[78]), c(d[79]), c(d[80]), c(d[81]), c(d[82]), c(d[83]), c(d[84]), \
      c(d[85]), c(d[86]), c(d[87]), c(d[88]), c(d[89]), c(d[90]), c(d[91]), c(d[92]), \
      c(d[93]), c(d[94]), c(d[95]), c(d[96]), c(d[97]), c(d[98]), c(d[99]), c(d[100]), \
      c(d[101]), c(d[102]), c(d[103]), c(d[104]), c(d[105]), c(d[106]), c(d[107]), \
      c(d[108]), c(d[109]), c(d[110]), c(d[111]), c(d[112]), c(d[113]), c(d[114]), \
      c(d[115]), c(d[116]), c(d[117]), c(d[118]), c(d[119]), c(d[120]), c(d[121]), \
      c(d[122]), c(d[123]), c(d[124]), c(d[125]), c(d[126]), c(d[127])
#define NOVA_WG_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, " \
  "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, " \
  "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " NOVA_WG_REGS128
      ", %128, %129, p;\n}\n"
      : NOVA_WG_D128("+r")
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 192, s32) (+)= A B, A (64 x 32 s8) and B (192 x 32 s8), both
// K-major in shared memory
#define NOVA_WG_D96(c) NOVA_WG_D64(c), c(d[64]), c(d[65]), c(d[66]), c(d[67]), c(d[68]), \
      c(d[69]), c(d[70]), c(d[71]), c(d[72]), c(d[73]), c(d[74]), c(d[75]), c(d[76]), \
      c(d[77]), c(d[78]), c(d[79]), c(d[80]), c(d[81]), c(d[82]), c(d[83]), c(d[84]), \
      c(d[85]), c(d[86]), c(d[87]), c(d[88]), c(d[89]), c(d[90]), c(d[91]), c(d[92]), \
      c(d[93]), c(d[94]), c(d[95])
#define NOVA_WG_REGS96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95}"
__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 " NOVA_WG_REGS96
      ", %96, %97, p;\n}\n"
      : NOVA_WG_D96("+r")
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 96, s32) (+)= A B, A (64 x 32 s8) and B (96 x 32 s8), both K-major
// in shared memory (row 1's v columns at head dim 96)
__device__ __forceinline__ void wgmma_s8_n96(int (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 " NOVA_WG_REGS48
      ", %48, %49, p;\n}\n"
      : NOVA_WG_D48("+r")
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128, f32) (+)= A B, A (64 x 16 bf16) from registers, B (128 x 16
// bf16) K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const unsigned (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NOVA_WG_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : NOVA_WG_D64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// 16-byte chunk c (0..15: columns 4c .. 4c + 3) of row r (0..63) of a 64 x
// 64 f32 tile held as two 64-row x 128-byte boxes (columns 0..31, 32..63) in
// the 128B swizzle, the layout TMA loads and reduce-adds (bhld_map with
// 4-byte elements): chunk c & 7 of a row at (c & 7) ^ (r & 7). Eight rows r
// with distinct r & 7 at one chunk, or eight chunks of one row, hit 32
// distinct banks. The f32 flash kernels' one layout (forward and backward).
__device__ __forceinline__ uint32_t f32_chunk(uint32_t tile, int r, int c) {
  return tile + ((c >> 3) << 13) + (r << 7) + ((((c & 7) ^ r) & 7) << 4);
}
__device__ __forceinline__ uint32_t f32_at(uint32_t tile, int r, int col) {
  return f32_chunk(tile, r, col >> 2) + ((col & 3) << 2);
}

// shared memory written by threads (the generic proxy), made visible to
// wgmma and TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// thread-block clusters: a block's rank, the cluster's index and count,
// another block's shared memory (distributed shared memory), its mbarriers,
// and the barrier of all the cluster's threads
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}
// the address of shared-memory word `addr` in the block of rank `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
// arrives on an mbarrier of any block of the cluster (a mapa address),
// releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote_bar)
               : "memory");
}
// mbar_wait with acquire at cluster scope: what other blocks wrote before
// arriving is visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// every thread of every block of the cluster (release, then acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// the registers of a warpgroup: all its threads give up (dec) or take (inc)
// registers up to N a thread
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---------------------------------------------------------------------------
// host: TMA maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled of libcuda, found at run time (the library links no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// a 4-D map (d, L, H, B) over a (B, H, L, d) view with element strides s
// (batch, head, row), d = 64 or 96: boxes of 128 bytes of a row in the 128B
// swizzle (64 bf16, or 32 f32 for the f32 kernels), of 64 bytes in the
// 64B swizzle (64 int8, or a 32-column panel of a 96-wide bf16 row) or of
// 32 bytes in the 32B swizzle (a 32-column panel of a 96-wide int8 row), by
// `box_rows` rows; rows past L read as zeros (within each (b, h)) and are
// not written
inline bool bhld_map(CUtensorMap* m, const void* ptr, int B, int H, int L, const long* s,
                     int box_rows = 64, int elem_bytes = 2, int d = 64) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (s[i] <= 0 || (s[i] * elem_bytes) % 16 != 0) return false;
  const cuuint64_t eb = static_cast<cuuint64_t>(elem_bytes);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(L),
                        static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[2]) * eb, static_cast<cuuint64_t>(s[1]) * eb,
                           static_cast<cuuint64_t>(s[0]) * eb};
  const cuuint32_t box_cols = elem_bytes == 4 || d != 64 ? 32u : 64u;
  cuuint32_t box[4] = {box_cols, static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return encode(m, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols * elem_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : box_cols * elem_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D map over a K-major int8 matrix (rows, K) row-major: boxes of 128
// bytes of K by `box_rows` rows, 128B swizzle (the layout of desc_sw128),
// rows past `rows` read as zeros
inline bool kmajor_map(CUtensorMap* m, const void* ptr, int rows, int K, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || K % 16 != 0 ||
      rows <= 0 || box_rows <= 0 || box_rows > 256)
    return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace nova
