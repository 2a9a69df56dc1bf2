// sm90_common.cuh: Hopper (sm_90a) primitives shared by the port's
// kernels: shared-memory addresses, mbarriers, TMA tile loads, proxy
// fences, named barriers, 16-byte cp.async, the 128-byte-swizzle wgmma
// descriptor and layout, the three-pass TF32 product of the fp32 routes,
// and the driver's tensor-map encoder fetched at run time
// (cudaGetDriverEntryPoint(ByVersion)), so no kernel library links
// libcuda. sm90_gemm.cuh (swap_linear, swap_linear_q), flash_attention.cuh
// and paged_attention.cu include it.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}


__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// byte offset of (row, byte) in a tile of 128-byte rows, 128-byte swizzle:
// the 16-byte chunk index is xored with row % 8, as TMA writes it
__device__ __forceinline__ int sw128(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
}

// A 4-D tile load: box origin (c0 innermost .. c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------ three-pass TF32
// fp32 products on the tensor cores at fp32 accuracy (the fp32 routes of
// swap_linear and flash_attention). Each operand is split explicitly,
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (ties away,
// cvt.rna); the subtraction is exact in fp32, so hi + lo keeps 22 of x's
// 24 significant bits. Raw fp32 bits are never handed to a TF32 operand:
// the tensor cores would read only the top 19 bits, truncating. A k8
// step's three products go small terms first, hi lo, then lo hi, then
// hi hi, into a partial sum that starts at zero on the tensor cores; after
// a few k8 steps that partial is added to the fp32 accumulator with one
// rounded fp32 add. lo lo (below 2^-22 of the product) is dropped. The
// accumulator never enters the tensor cores: their sums are not rounded
// to nearest, and fed back through them at every step an accumulator
// drifted past 1e-5 of the fp32 result at K 2,048-10,240 on an H100. So
// the error stays near that of kernels/tf32.py's model (which emulates a
// partial a k8 step on the CPU), about 1e-6 of the largest output at K
// 10,240, inside the 1e-5 of fp32 parity that one pass (~3e-4) fails.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi is cvt.rna's result by two integer operations (add half of the 13
// dropped bits' unit to the magnitude, clear them; inf stays inf), lo the
// exact residual through cvt.rna itself, which keeps a NaN of x (hi may
// lose it) in the products. An infinite x gives NaN (inf - inf), as it
// did with both through cvt.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d[16 x 8] (+)= a[16 x 8] b[8 x 8], one mma.sync.m16n8k8 in TF32 (zero:
// d = a b). Fragments (lane = 4 g + t): a0 (row g, k t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, col g), b1 (t + 4, g); d0,
// d1 (row g, cols 2 t, 2 t + 1), d2, d3 (row g + 8). The callers place
// physical k 2 t and 2 t + 1 at the instruction's k t and t + 4 (a
// permutation of the k8 step, the same for both operands), so a thread's
// two k values of a row are neighbours: one 8-byte load, and an
// accumulator's (d0, d2, d1, d3) is the A fragment of the next product.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// p += a b over one k8 step in three TF32 passes, small terms first,
// summed on the tensor cores (first: p starts at zero). The caller adds p
// to its fp32 accumulator with a rounded add after a few k8 steps
// (swap_linear: a 32-deep k tile, 12 products; flash_attention: a k32 of
// Q K^T, a 64-key tile of P V), so the tensor cores' own rounding stays
// relative to a partial, never to the running sum.
__device__ __forceinline__ void mma_3xtf32(float (&p)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2],
                                           bool first) {
  if (first) {
    mma_tf32_zero(p, ah, bl[0], bl[1]);
  } else {
    mma_tf32(p, ah, bl[0], bl[1]);
  }
  mma_tf32(p, al, bh[0], bh[1]);
  mma_tf32(p, ah, bh[0], bh[1]);
}

template <int N>
__device__ __forceinline__ void add_rn(float (&acc)[N], const float (&p)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = __fadd_rn(acc[c], p[c]);
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}


}  // namespace
