// sm90_gemm.cuh: the weight-streaming matmul core shared by swap_linear
// (csrc/swap_linear.cu, TPU kernel src/repro/kernels/swap_linear.py) and
// swap_linear_q (csrc/swap_linear_q.cu, src/repro/kernels/swap_linear_q.py),
// for Hopper (sm_90a):
//
//   y[m, n] = act(sum_k x[m, k] w[k, n] * scale[n] + bias[n])
//
// w is bf16 or fp32 (swap_linear, the dtype of x), or int8 or int4 still
// quantized (swap_linear_q: [K, N] int8, or the [ceil(K/2), N] carrier whose
// low nibble holds the even k). scale (B1 only) is fp32 or null, bias fp32
// or bf16 (read as it is: no cast before the launch) or null.
//
// What bounds it on an H100: at prefill (M in the hundreds or thousands) the
// arithmetic, 2 M N K flops; at decode (M = 1..4) the weight bytes. Three
// cores, chosen by (x dtype, weight kind):
//
// * tc_gemm, bf16 x: the tensor cores. One block per 128-column output
//   tile of 128 rows (two consumer warpgroups) or 64 rows (one), plus a
//   producer warpgroup: one thread keeps
//   TMA loads in flight into a ring of 4 stages in dynamic shared memory (x
//   tile rows x 64 K-major, weight tile 64 x 128 with N contiguous),
//   completion reported to mbarriers. Each consumer warpgroup runs
//   wgmma.mma_async m64n128k16 on its 64 rows with fp32 accumulators in
//   registers. Both operands are 128-byte swizzled; the weight is MN-major,
//   so its descriptor steps k by 8-row groups, its two 64-column boxes lie
//   one box apart, and the instruction sets the transpose flag for B. An
//   int8 or int4 weight tile arrives still quantized (no swizzle), and
//   widening warpgroups of their own (two beside one consumer warpgroup,
//   one beside two) widen it to bf16 into one of two buffers laid out
//   exactly as TMA would lay out a bf16 tile, while the consumers run the
//   wgmmas of the tile before. Every int8 / int4 value is
//   exact in bf16, so the products are exact and the scale factors out of
//   the k-sum. The weight never exists as fp in device memory.
// * tf32_gemm, fp32 x and an fp32 weight: the tensor cores in three-pass
//   TF32 (sm90_common.cuh: each operand split into TF32 hi and lo, hi lo
//   + lo hi + hi hi summed on the tensor cores over a 32-deep k tile, then
//   added to fp32 accumulators), within 1e-5 of the plain fp32 version.
//   256 threads, a row tile of 16 rows (M <= 16: eight warps side by side
//   over the 128 columns, three blocks an SM), 64 or 128 (2 x 4 warps of 32
//   or 64 x 32; 128 once such tiles fill the card twice), 16-byte cp.async
//   loads into a ring of 3 (16 rows) or 4 stages of 32-deep k-steps (x
//   rows padded to 40 floats, weight rows to 132, so every fragment load
//   is free of bank conflicts), mma.sync.m16n8k8. Both operands are read
//   as they land and split in registers: mma.sync's B fragment takes two k
//   of one column of the N-contiguous weight, so no pass transposes it, as
//   wgmma's K-major TF32 operand would need; at decode shared memory
//   carries each weight byte in and out once, against about seven times
//   through a split-and-transpose stage for wgmma, so M 1 stays
//   bytes-bound.
// * simt_gemm, fp32 x and an int8 or int4 weight: the CUDA cores in fp32.
//   256 threads, a row tile of 8 or 64 rows, 16-byte cp.async loads into a
//   3- or 4-stage ring; each output is one fma chain over k in order.
//
// The launch plan (kernels/gemm_plan.py) decides the row tile, the k-split
// and how the splits are combined; this file only checks that it can run
// the plan it is given. Decode fills the card by splitting K: S splits of
// equal k-tile counts, S a function of (N, K, dtype) alone. With the
// "blocks" and "pass" combines each block computes one split into fp32
// scratch, and the S partials are added in order: by the last block of
// each output tile to finish (an atomic count per tile; "blocks", one row
// tile, as at decode) or by a second kernel over the whole output ("pass",
// several row tiles, whose sums the last blocks alone would add on too few
// SMs). With "serial" a block walks all S splits itself and adds each
// split's sum to its running total in the same order. All give the same
// bits.
//
// Rows do not depend on M: everything that sets the order of an output's
// sum (the instruction shape, the k-tile order, S and its boundaries, the
// order the partials are added in) depends on (N, K, dtype) only, the
// epilogue rounds explicitly (no contraction that could differ between the
// combines), and no value is added atomically (the one atomic counts a
// tile's arrivals). Row i of an M-row call equals the
// 1-row call on that row bitwise, which paged batched decode (M = batch)
// needs to reproduce solo runs (M = 1).
//
// Ragged shapes: TMA zero-fills out-of-bounds boxes but needs 16-byte
// aligned bases and row strides (K % 8 for x, N % 8 for a bf16 weight,
// N % 16 for int8 and the int4 carrier). Where those fail the producer
// warpgroup takes the second load route, masked plain loads into the same
// shared-memory tiles in the same layout, read by the same wgmma sequence:
// the output bits do not depend on the route. The fp32-x cores take
// cp.async where x rows and weight rows are 16-byte aligned, plain loads
// elsewhere.
//
// The tensor-map encoder is a driver function; it is fetched at run time
// with cudaGetDriverEntryPoint(ByVersion), so the library links no libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "sm90_common.cuh"

namespace {

// ------------------------------------------------------------ plan constants
// (the codes and tiles of src/repro_torch/kernels/gemm_plan.py)
constexpr int W_FP = 0;            // weight in x's dtype
constexpr int W_INT8 = 8;
constexpr int W_INT4 = 4;
constexpr int ROUTE_FAST = 0;      // TMA (bf16 x) or cp.async (fp32 x)
constexpr int ROUTE_PLAIN = 1;     // masked plain loads
constexpr int COMBINE_NONE = 0;    // one split
constexpr int COMBINE_SERIAL = 1;  // a block walks every split itself
constexpr int COMBINE_BLOCKS = 2;  // one split per block, fp32 scratch,
                                   // added by the last block of a tile
constexpr int COMBINE_PASS = 3;    // ... added by a second kernel
constexpr int COUNTERS = 132;      // the wrapper's per-tile arrival counts

// tensor-core core: NC consumer warpgroups of 64 rows each (a row tile of
// 64 or 128), one producer warpgroup
constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_STAGES = 4;
constexpr int TC_BOX_BYTES = TC_BK * 64 * 2;         // one 64-column bf16 box
constexpr int TC_WB_BYTES = 2 * TC_BOX_BYTES;        // a bf16 weight tile

template <int WK, int NC> struct TcTile {
  static constexpr int BM = 64 * NC;
  static constexpr int CT = 128 * NC;                 // consumer threads
  // + a producer warpgroup, + the threads that widen a quantized weight:
  // two warpgroups beside one consumer warpgroup (whose wgmmas then take as
  // long as a widening by one), one beside two
  static constexpr int WT = WK == W_FP ? 0 : (NC == 1 ? 256 : 128);
  static constexpr int THREADS = CT + 128 + WT;
  // registers a consumer thread may hold: what the others give up (40 a
  // producer thread, 56 a widening one) out of the 64K of the SM
  static constexpr int CONSUMER_REGS = WK == W_FP || NC == 1 ? 232 : 200;
  static constexpr int X_BYTES = BM * TC_BK * 2;
  static constexpr int W_BYTES = WK == W_FP ? TC_WB_BYTES
                               : WK == W_INT8 ? TC_BK * TC_BN
                               : TC_BK / 2 * TC_BN;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;   // 1 KB multiple
  static constexpr int WIDE_BYTES = WK == W_FP ? 0 : 2 * TC_WB_BYTES;
  static constexpr int BAR_OFF = TC_STAGES * STAGE_BYTES + WIDE_BYTES;
  // + the mbarriers + slack to align the base to 1 KB (128-byte swizzle)
  static constexpr int SMEM_BYTES = BAR_OFF + (2 * TC_STAGES + 4) * 8 + 1024;
};

// CUDA-core core (a quantized weight under fp32 x) and three-pass TF32 core
// (an fp32 weight): 256 threads, the same cp.async ring (gemm_stage)
constexpr int SIMT_THREADS = 256;
template <int WK, int BM> struct SimtTile {
  static_assert(WK != W_FP, "an fp32 weight takes the TF32 core");
  static constexpr int ROWS = BM;
  static constexpr int BN = BM == 8 ? 128 : 64;
  static constexpr int BK = 32;
  static constexpr int STAGES = BM == 8 ? 4 : 3;
  static constexpr int TM = BM == 8 ? 1 : 4;          // rows per thread
  static constexpr int TX = BN / 4;                   // threads across N
  static constexpr int XLD = BK + 4;                  // x row stride, floats
  static constexpr int X_BYTES = BM * XLD * 4;
  static constexpr int W_ROWS = WK == W_INT4 ? BK / 2 : BK;
  static constexpr int W_LD = BN;                     // bytes per row
  static constexpr int STAGE_BYTES = X_BYTES + W_ROWS * W_LD;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

template <int BM> struct Tf32Tile {
  static constexpr int ROWS = BM;
  static constexpr int BN = 128, BK = 32;
  // 16 rows: 3 stages, three blocks an SM (decode streams the weight: 24
  // warps an SM keep more of it in flight); 64 and 128 rows: 4 stages
  static constexpr int STAGES = BM == 16 ? 3 : 4;
  static constexpr int WARPS_M = BM == 16 ? 1 : 2;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int MT = BM / WARPS_M / 16;        // m16 tiles a warp
  static constexpr int NT = BN / WARPS_N / 8;         // n8 tiles a warp
  // row strides: 40 floats (8 mod 32) make the 8-byte x fragment loads of
  // a half-warp hit 32 banks once; 132 (4 mod 32) the weight's 4-byte
  // loads of k 2 t and 2 t + 1 at column g
  static constexpr int XLD = BK + 8;
  static constexpr int WLD = BN + 4;                  // floats
  static constexpr int X_BYTES = BM * XLD * 4;
  static constexpr int W_ROWS = BK;
  static constexpr int W_LD = WLD * 4;                // bytes per row
  static constexpr int STAGE_BYTES = X_BYTES + W_ROWS * W_LD;
  // a thread's outputs: their sum over the serial splits lives in shared
  // memory past the ring, registers holding the split's sum and the k
  // tile's partial
  static constexpr int OUTS = MT * NT * 4;
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + OUTS * SIMT_THREADS * 4;
  static constexpr int MIN_BLOCKS = BM == 16 ? 3 : 1;
  static_assert(BM == 16 || BM == 64 || BM == 128, "the plan's row tiles");
};

struct GemmArgs {
  const void* x;
  const void* w;
  const float* scales;     // null for swap_linear
  const void* bias;        // may be null
  void* out;
  float* partial;          // [splits, M, ldp] fp32: "blocks" and "pass"
  int* counters;           // blocks arrived per output tile, 0 between calls
  int M, N, K;
  int act;                 // 0 none, 1 silu, 2 tanh-gelu
  int bias_bf16;           // the bias is bf16 (else fp32)
  int splits;
  int combine;             // COMBINE_NONE, _SERIAL, _BLOCKS or _PASS
  int ldp;                 // partial row stride: N rounded up to 4
};

__host__ __device__ __forceinline__ int split_start(int s, int ktiles,
                                                    int splits) {
  return (int)(((long long)s * ktiles) / splits);
}

// ------------------------------------------------------------- epilogue
// Explicit roundings: the serial and the "blocks" combine must give the same
// bits, so no step may be contracted into an fma in one and not the other.
__device__ __forceinline__ float activate(float r, int act) {
  if (act == 1) {                       // silu
    return __fmul_rn(r, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-r))));
  }
  if (act == 2) {                       // gelu, tanh approximation
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, r), r), r);
    const float t = tanhf(__fmul_rn(c, __fadd_rn(r, cube)));
    return __fmul_rn(__fmul_rn(0.5f, r), __fadd_rn(1.0f, t));
  }
  return r;
}

__device__ __forceinline__ float finish(float r, int n, const GemmArgs& a) {
  if (a.scales != nullptr) r = __fmul_rn(r, a.scales[n]);
  if (a.bias != nullptr) {
    r = __fadd_rn(r, a.bias_bf16
                         ? __bfloat162float(
                               static_cast<const __nv_bfloat16*>(a.bias)[n])
                         : static_cast<const float*>(a.bias)[n]);
  }
  return activate(r, a.act);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Columns n and n + 1 (n even) of row m of the CUDA-core core's fp32
// output: the partial sums of this block's split, or the finished outputs.
__device__ __forceinline__ void store_pair(const GemmArgs& a, int m, int n,
                                           float v0, float v1) {
  if (m >= a.M || n >= a.N) return;
  if (a.partial != nullptr) {
    *reinterpret_cast<float2*>(
        a.partial + ((size_t)blockIdx.z * a.M + m) * a.ldp + n) =
        make_float2(v0, v1);
    return;
  }
  float* o = static_cast<float*>(a.out) + (size_t)m * a.N + n;
  o[0] = finish(v0, n, a);
  if (n + 1 < a.N) o[1] = finish(v1, n + 1, a);
}

// The "pass" combine: out = finish(p[0] + p[1] + ... + p[S-1]), in that
// order, over the whole output.
template <typename OutT>
__global__ void __launch_bounds__(256) split_sum(const GemmArgs a) {
  const size_t total = (size_t)a.M * a.N;
  const size_t plane = (size_t)a.M * a.ldp;
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (size_t)gridDim.x * 256) {
    const int m = (int)(i / a.N), n = (int)(i % a.N);
    const float* p = a.partial + (size_t)m * a.ldp + n;
    float r = p[0];
    for (int s = 1; s < a.splits; ++s) r = __fadd_rn(r, p[s * plane]);
    static_cast<OutT*>(a.out)[i] = from_f<OutT>(finish(r, n, a));
  }
}

// ------------------------------------------------------- int -> float
// Byte b of u as the float 2^23 + b (exact), by placing it under the
// exponent of 2^23: cheaper than an integer-to-float conversion.
__device__ __forceinline__ float biased_byte(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel));
}

// four int8 (or four int4 nibbles of one half) of a 32-bit word as fp32,
// exactly (the CUDA-core core)
template <int WK, int HIGH>
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  uint32_t u;
  float bias;
  if (WK == W_INT8) {
    u = w ^ 0x80808080u;                            // v + 128
    bias = 8388736.0f;                              // 2^23 + 128
  } else {
    u = ((HIGH ? (w >> 4) : w) & 0x0F0F0F0Fu) ^ 0x08080808u;   // v + 8
    bias = 8388616.0f;                              // 2^23 + 8
  }
  f[0] = biased_byte(u, 0x7540) - bias;
  f[1] = biased_byte(u, 0x7541) - bias;
  f[2] = biased_byte(u, 0x7542) - bias;
  f[3] = biased_byte(u, 0x7543) - bias;
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return h;
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// Two int8 bytes of w (sel picks them) as the bf16x2 of their values,
// exactly: each 16-bit lane becomes 0x43 over the byte; with bit 7 cleared
// that is the bf16 128 + (b & 127), with only bit 7 kept 128 or 256, and
// their difference is the byte's signed value.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0x43434343u, sel);
  return bits_of(__hsub2(as_bf16x2(p & 0xFF7FFF7Fu),
                         as_bf16x2(p & 0xFF80FF80u)));
}

// Two int4 values, the low nibbles of two bytes of w: 0x43 over (n ^ 8) is
// the bf16 128 + 8 + n's signed value, less 136.
__device__ __forceinline__ uint32_t i4x2_bf16(uint32_t w, uint32_t sel) {
  const uint32_t p = (__byte_perm(w, 0x43434343u, sel) & 0xFF0FFF0Fu) ^
                     0x00080008u;
  return bits_of(__hsub2(as_bf16x2(p), as_bf16x2(0x43084308u)));
}

// ----------------------------------------------------------------- PTX
// The "blocks" combine, called by the NT threads that wrote this block's
// partial sums: the last block of the output tile to arrive adds the S
// partials in the order 0..S-1, applies the epilogue and writes the tile,
// then resets the tile's count for the next call on the stream. The count
// of tile (row tile x, column tile y) is x + y * (row tiles), below COUNTERS
// (check_plan).
template <typename OutT, int NT>
__device__ void combine_if_last(const GemmArgs& a, int m0, int n0, int bm,
                                int bn, int tid) {
  __shared__ int last;
  __threadfence();
  named_sync(1, NT);
  if (tid == 0) {
    int* count = a.counters + blockIdx.x + blockIdx.y * gridDim.x;
    last = atomicAdd(count, 1) == a.splits - 1;
    if (last) *count = 0;
  }
  named_sync(1, NT);
  if (!last) return;
  __threadfence();
  // four columns a step (ldp and n0 are multiples of 4), four splits' loads
  // in flight before they are added in order
  const size_t plane = (size_t)a.M * a.ldp;
  const int rows = min(bm, a.M - m0), quads = bn / 4;
  for (int g = tid; g < rows * quads; g += NT) {
    const int m = m0 + g / quads, n = n0 + (g % quads) * 4;
    if (n >= a.N) continue;
    const float* p = a.partial + (size_t)m * a.ldp + n;
    float4 r = __ldcg(reinterpret_cast<const float4*>(p));
    int s = 1;
    for (; s + 4 <= a.splits; s += 4) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = __ldcg(reinterpret_cast<const float4*>(p + (s + j) * plane));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r.x = __fadd_rn(r.x, v[j].x);
        r.y = __fadd_rn(r.y, v[j].y);
        r.z = __fadd_rn(r.z, v[j].z);
        r.w = __fadd_rn(r.w, v[j].w);
      }
    }
    for (; s < a.splits; ++s) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + s * plane));
      r.x = __fadd_rn(r.x, v.x);
      r.y = __fadd_rn(r.y, v.y);
      r.z = __fadd_rn(r.z, v.z);
      r.w = __fadd_rn(r.w, v.w);
    }
    OutT* o = static_cast<OutT*>(a.out) + (size_t)m * a.N + n;
    const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n + j < a.N) o[j] = from_f<OutT>(finish(rv[j], n + j, a));
    }
  }
}


__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 128] += A[64 x 16] (K-major) * B[16 x 128] (MN-major: trans-b =
// 1). B spans two 64-column swizzle atoms, LBO apart along N; its 8-row k
// groups are SBO apart.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// --------------------------------------------------- tensor-core core
// Masked plain loads of one stage, by the producer warpgroup's 128 threads,
// into the layout TMA would write (the second load route).
template <int WK, int NC>
__device__ void plain_stage(uint8_t* st, const GemmArgs& a, int m0, int n0,
                            int k0, int t) {
  using L = TcTile<WK, NC>;
  const uint16_t* x = static_cast<const uint16_t*>(a.x);
  for (int e = t; e < L::BM * TC_BK; e += 128) {
    const int r = e >> 6, c = e & 63;
    const int gm = m0 + r, gk = k0 + c;
    *reinterpret_cast<uint16_t*>(st + sw128(r, 2 * c)) =
        (gm < a.M && gk < a.K) ? x[(size_t)gm * a.K + gk] : (uint16_t)0;
  }
  uint8_t* wt = st + L::X_BYTES;
  if (WK == W_FP) {
    const uint16_t* w = static_cast<const uint16_t*>(a.w);
    for (int e = t; e < TC_BK * TC_BN; e += 128) {
      const int r = e >> 7, c = e & 127;
      const int gk = k0 + r, gn = n0 + c;
      *reinterpret_cast<uint16_t*>(wt + (c >> 6) * TC_BOX_BYTES +
                                   sw128(r, 2 * (c & 63))) =
          (gk < a.K && gn < a.N) ? w[(size_t)gk * a.N + gn] : (uint16_t)0;
    }
  } else {
    const int8_t* q = static_cast<const int8_t*>(a.w);
    constexpr int ROWS = WK == W_INT8 ? TC_BK : TC_BK / 2;
    const int Kq = WK == W_INT8 ? a.K : (a.K + 1) / 2;
    const int q0 = WK == W_INT8 ? k0 : k0 / 2;
    for (int e = t; e < ROWS * TC_BN; e += 128) {
      const int r = e >> 7, c = e & 127;
      const int gq = q0 + r, gn = n0 + c;
      wt[r * TC_BN + c] =
          (gq < Kq && gn < a.N) ? q[(size_t)gq * a.N + gn] : (int8_t)0;
    }
  }
}

// Widen a quantized weight tile (int8 [64][128], or the int4 carrier
// [32][128]) into a bf16 tile in the swizzled layout of two TMA boxes, by
// NT widening threads (128 or 256): thread t takes the 8-column chunk
// t % 16 of every (NT / 16)-th row from t / 16, a multiple of 8 apart, so
// its swizzle is the same at every step. 16 bytes out a step.
template <int WK, int NT>
__device__ __forceinline__ void widen_tile(const uint8_t* qt, uint8_t* wide,
                                           int t) {
  constexpr int STEP = NT / 16;
  const int nc = t & 15;
  uint8_t* box = wide + (nc >> 3) * TC_BOX_BYTES;
  if (WK == W_INT8) {
    const int sw = ((nc & 7) ^ ((t >> 4) & 7)) << 4;
#pragma unroll
    for (int it = 0; it < TC_BK / STEP; ++it) {
      const int k = (t >> 4) + STEP * it;
      const uint2 v = *reinterpret_cast<const uint2*>(qt + k * TC_BN + nc * 8);
      *reinterpret_cast<uint4*>(box + k * 128 + sw) =
          make_uint4(i8x2_bf16(v.x, 0x5140), i8x2_bf16(v.x, 0x5342),
                     i8x2_bf16(v.y, 0x5140), i8x2_bf16(v.y, 0x5342));
    }
  } else {
#pragma unroll
    for (int it = 0; it < TC_BK / 2 / STEP; ++it) {
      const int kq = (t >> 4) + STEP * it;      // rows k = 2 kq and 2 kq + 1
      const uint2 v = *reinterpret_cast<const uint2*>(qt + kq * TC_BN + nc * 8);
      const uint32_t hx = v.x >> 4, hy = v.y >> 4;
      *reinterpret_cast<uint4*>(box + sw128(2 * kq, (nc & 7) * 16)) =
          make_uint4(i4x2_bf16(v.x, 0x5140), i4x2_bf16(v.x, 0x5342),
                     i4x2_bf16(v.y, 0x5140), i4x2_bf16(v.y, 0x5342));
      *reinterpret_cast<uint4*>(box + sw128(2 * kq + 1, (nc & 7) * 16)) =
          make_uint4(i4x2_bf16(hx, 0x5140), i4x2_bf16(hx, 0x5342),
                     i4x2_bf16(hy, 0x5140), i4x2_bf16(hy, 0x5342));
    }
  }
}

template <int WK, int NC>
__global__ void __launch_bounds__(TcTile<WK, NC>::THREADS, 1)
tc_gemm(const __grid_constant__ CUtensorMap tm_x,
        const __grid_constant__ CUtensorMap tm_w, const GemmArgs a,
        const int route) {
  using L = TcTile<WK, NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wide = smem + TC_STAGES * L::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + TC_STAGES;
  uint64_t* wfull = empty + TC_STAGES;     // a widened tile is ready
  uint64_t* wempty = wfull + 2;            // its wgmmas have completed

  const int m0 = blockIdx.x * L::BM, n0 = blockIdx.y * TC_BN;
  const int ktiles = (a.K + TC_BK - 1) / TC_BK;
  const bool serial = a.combine == COMBINE_SERIAL;
  const int s_lo = serial ? 0 : (int)blockIdx.z;
  const int s_hi = serial ? a.splits : s_lo + 1;
  const int kt_lo = split_start(s_lo, ktiles, a.splits);
  const int kt_hi = split_start(s_hi, ktiles, a.splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], route == ROUTE_FAST ? 1 : 128);
      mbar_init(&empty[s], L::CT);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&wfull[b], L::WT);
      mbar_init(&wempty[b], L::CT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= L::CT + 128) {
    // ---- widening warpgroups (quantized weights only)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    const int t = threadIdx.x - L::CT - 128;
    for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
      const int s = i % TC_STAGES, b = i & 1;
      mbar_wait(&full[s], (i / TC_STAGES) & 1);
      mbar_wait(&wempty[b], ((i >> 1) & 1) ^ 1);
      widen_tile<WK, L::WT>(smem + s * L::STAGE_BYTES + L::X_BYTES,
                            wide + b * TC_WB_BYTES, t);
      fence_proxy_async();
      mbar_arrive(&wfull[b]);
    }
  } else if (threadIdx.x >= L::CT) {
    // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int t = threadIdx.x - L::CT;
    if (route == ROUTE_FAST) {
      if (t == 0) {
        for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
          const int s = i % TC_STAGES;
          mbar_wait(&empty[s], ((i / TC_STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * L::STAGE_BYTES;
          mbar_expect_tx(&full[s], L::STAGE_BYTES);
          tma_load_2d(st, &tm_x, &full[s], kt * TC_BK, m0);
          uint8_t* wt = st + L::X_BYTES;
          if (WK == W_FP) {
            tma_load_2d(wt, &tm_w, &full[s], n0, kt * TC_BK);
            tma_load_2d(wt + TC_BOX_BYTES, &tm_w, &full[s], n0 + 64,
                        kt * TC_BK);
          } else {
            tma_load_2d(wt, &tm_w, &full[s], n0,
                        WK == W_INT8 ? kt * TC_BK : kt * (TC_BK / 2));
          }
        }
      }
    } else {
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int s = i % TC_STAGES;
        mbar_wait(&empty[s], ((i / TC_STAGES) & 1) ^ 1);
        plain_stage<WK, NC>(smem + s * L::STAGE_BYTES, a, m0, n0,
                            kt * TC_BK, t);
        fence_proxy_async();
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(L::CONSUMER_REGS));
    const int ct = threadIdx.x;
    const int wg = ct >> 7;
    const int nkt = kt_hi - kt_lo;
    float acc[64], tot[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.0f;
    int sp = s_lo;                                  // the split being summed
    int sp_end = split_start(sp + 1, ktiles, a.splits) - kt_lo;
    for (int i = 0; i < nkt; ++i) {
      const int s = i % TC_STAGES, b = i & 1;
      uint8_t* st = smem + s * L::STAGE_BYTES;
      mbar_wait(&full[s], (i / TC_STAGES) & 1);
      if (WK != W_FP) mbar_wait(&wfull[b], (i >> 1) & 1);
      const uint32_t xa = smem_u32(st) + wg * (64 * 128);
      const uint32_t ba = WK == W_FP ? smem_u32(st + L::X_BYTES)
                                     : smem_u32(wide + b * TC_WB_BYTES);
      reg_fence(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        // A: K-major, 8-row groups 1 KB apart, k16 = 32 bytes into the
        // swizzled row. B: MN-major, 8-row k groups 1 KB apart (SBO), the
        // two 64-column boxes one box apart (LBO), 2 KB per k16 step.
        wgmma_m64n128k16(acc, sw128_desc(xa + kk * 32, 16, 1024),
                         sw128_desc(ba + kk * 2048, TC_BOX_BYTES, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // keep this tile's wgmmas in flight and release the tile before
      if (i > 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        reg_fence(acc);
        mbar_arrive(&empty[(i - 1) % TC_STAGES]);
        if (WK != W_FP) mbar_arrive(&wempty[(i - 1) & 1]);
      }
      if (i + 1 == sp_end) {                        // a split is complete
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        reg_fence(acc);
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          tot[r] = sp == s_lo ? acc[r] : __fadd_rn(tot[r], acc[r]);
          acc[r] = 0.0f;
        }
        ++sp;
        sp_end = split_start(sp + 1, ktiles, a.splits) - kt_lo;
      }
    }
    if (nkt > 0) {                                  // release the last tile
      mbar_arrive(&empty[(nkt - 1) % TC_STAGES]);
      if (WK != W_FP) mbar_arrive(&wempty[(nkt - 1) & 1]);
    } else {                                        // K = 0: the sum is 0
#pragma unroll
      for (int r = 0; r < 64; ++r) tot[r] = 0.0f;
    }
    // The epilogue goes through shared memory (the ring is free once every
    // consumer is past its last wgmma): the fragments are stored as fp32,
    // then the threads walk the tile row by row, so the stores are
    // coalesced and the epilogue's code is one loop. Fragment of m64n128:
    // register 4j + q holds row (lane / 4) + 8 (q / 2) of this warp's 16,
    // column 8 j + 2 (lane % 4) + q % 2.
    constexpr int LD = TC_BN + 8;               // conflict-free float2 rows
    static_assert(TC_STAGES * L::STAGE_BYTES >= L::BM * LD * 4,
                  "the epilogue tile must fit in the ring");
    float* ep = reinterpret_cast<float*>(smem);
    const int lane = ct & 31, warp = (ct >> 5) & 3;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2);
    named_sync(1, L::CT);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = j * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(ep + r0 * LD + c) =
          make_float2(tot[4 * j], tot[4 * j + 1]);
      *reinterpret_cast<float2*>(ep + (r0 + 8) * LD + c) =
          make_float2(tot[4 * j + 2], tot[4 * j + 3]);
    }
    named_sync(1, L::CT);
    const int rows = min(L::BM, a.M - m0), cols = min(TC_BN, a.N - n0);
    for (int e = ct; e < rows * TC_BN; e += L::CT) {
      const int r = e / TC_BN, c = e % TC_BN;
      if (c >= cols) continue;
      const float v = ep[r * LD + c];
      const int m = m0 + r, n = n0 + c;
      if (a.partial != nullptr) {
        a.partial[((size_t)blockIdx.z * a.M + m) * a.ldp + n] = v;
      } else {
        static_cast<__nv_bfloat16*>(a.out)[(size_t)m * a.N + n] =
            __float2bfloat16(finish(v, n, a));
      }
    }
    if (a.counters != nullptr) {
      combine_if_last<__nv_bfloat16, L::CT>(a, m0, n0, L::BM, TC_BN, ct);
    }
  }
}

// ------------------------------------------- CUDA-core and TF32 cores
// One stage of the fp32-x cores' ring (layout L: SimtTile or Tf32Tile):
// x rows of BK floats at stride XLD, weight rows at W_LD bytes; cp.async
// (route fast) or masked plain loads, zeros past M, K and N.
template <int WK, typename L>
__device__ __forceinline__ void gemm_stage(uint8_t* st, const GemmArgs& a,
                                           int m0, int n0, int kt, int route,
                                           int tid) {
  constexpr int BM = L::ROWS;
  const int k0 = kt * L::BK;
  const float* x = static_cast<const float*>(a.x);
  float* xs = reinterpret_cast<float*>(st);
  uint8_t* ws = st + L::X_BYTES;
  const int Kq = WK == W_INT4 ? (a.K + 1) / 2 : a.K;
  const int q0 = WK == W_INT4 ? k0 / 2 : k0;
  if (route == ROUTE_FAST) {
    for (int e = tid; e < BM * (L::BK / 4); e += SIMT_THREADS) {
      const int r = e / (L::BK / 4), c = (e % (L::BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + c;
      const bool ok = gm < a.M && gk < a.K;
      cp_async16(xs + r * L::XLD + c, ok ? x + (size_t)gm * a.K + gk : x, ok);
    }
    constexpr int EL = WK == W_FP ? 4 : 16;           // elements per chunk
    constexpr int CPR = L::BN / EL;                   // chunks per row
    const uint8_t* w = static_cast<const uint8_t*>(a.w);
    const int es = WK == W_FP ? 4 : 1;
    for (int e = tid; e < L::W_ROWS * CPR; e += SIMT_THREADS) {
      const int r = e / CPR, c = (e % CPR) * EL;
      const int gq = q0 + r, gn = n0 + c;
      const bool ok = gq < Kq && gn < a.N;
      cp_async16(ws + r * L::W_LD + c * es,
                 ok ? w + ((size_t)gq * a.N + gn) * es : w, ok);
    }
  } else {
    for (int e = tid; e < BM * L::BK; e += SIMT_THREADS) {
      const int r = e / L::BK, c = e % L::BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r * L::XLD + c] = (gm < a.M && gk < a.K) ? x[(size_t)gm * a.K + gk] : 0.0f;
    }
    for (int e = tid; e < L::W_ROWS * L::BN; e += SIMT_THREADS) {
      const int r = e / L::BN, c = e % L::BN;
      const int gq = q0 + r, gn = n0 + c;
      const bool ok = gq < Kq && gn < a.N;
      if (WK == W_FP) {
        reinterpret_cast<float*>(ws + r * L::W_LD)[c] =
            ok ? static_cast<const float*>(a.w)[(size_t)gq * a.N + gn] : 0.0f;
      } else {
        ws[r * L::W_LD + c] =
            ok ? static_cast<const uint8_t*>(a.w)[(size_t)gq * a.N + gn] : 0;
      }
    }
  }
}

template <int WK, int BM>
__global__ void __launch_bounds__(SIMT_THREADS)
simt_gemm(const GemmArgs a, const int route) {
  using L = SimtTile<WK, BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int tx = tid % L::TX, ty = tid / L::TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * L::BN;
  const int ktiles = (a.K + L::BK - 1) / L::BK;
  const bool serial = a.combine == COMBINE_SERIAL;
  const int s_lo = serial ? 0 : (int)blockIdx.z;
  const int s_hi = serial ? a.splits : s_lo + 1;
  const int kt_lo = split_start(s_lo, ktiles, a.splits);
  const int nkt = split_start(s_hi, ktiles, a.splits) - kt_lo;

#pragma unroll
  for (int p = 0; p < L::STAGES - 1; ++p) {
    if (p < nkt) gemm_stage<WK, L>(smem + p * L::STAGE_BYTES, a, m0, n0,
                                    kt_lo + p, route, tid);
    cp_async_commit();
  }
  float acc[L::TM][4], tot[L::TM][4];
  int i = 0;
  for (int sp = s_lo; sp < s_hi; ++sp) {
#pragma unroll
    for (int r = 0; r < L::TM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    const int kt_end = split_start(sp + 1, ktiles, a.splits);
    for (int kt = split_start(sp, ktiles, a.splits); kt < kt_end; ++kt, ++i) {
      cp_async_wait<L::STAGES - 2>();
      __syncthreads();
      const int nx = i + L::STAGES - 1;
      if (nx < nkt) gemm_stage<WK, L>(smem + (nx % L::STAGES) * L::STAGE_BYTES,
                                       a, m0, n0, kt_lo + nx, route, tid);
      cp_async_commit();
      const uint8_t* st = smem + (i % L::STAGES) * L::STAGE_BYTES;
      const float* xs = reinterpret_cast<const float*>(st);
      const uint8_t* ws = st + L::X_BYTES;
#pragma unroll
      for (int kk = 0; kk < L::BK; ++kk) {
        float av[L::TM], bv[4];
#pragma unroll
        for (int r = 0; r < L::TM; ++r) av[r] = xs[(ty * L::TM + r) * L::XLD + kk];
        if (WK == W_INT8) {
          widen4<W_INT8, 0>(*reinterpret_cast<const uint32_t*>(ws + kk * L::W_LD + tx * 4), bv);
        } else if (kk & 1) {
          widen4<W_INT4, 1>(*reinterpret_cast<const uint32_t*>(ws + (kk >> 1) * L::W_LD + tx * 4), bv);
        } else {
          widen4<W_INT4, 0>(*reinterpret_cast<const uint32_t*>(ws + (kk >> 1) * L::W_LD + tx * 4), bv);
        }
#pragma unroll
        for (int r = 0; r < L::TM; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < L::TM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tot[r][c] = sp == s_lo ? acc[r][c] : __fadd_rn(tot[r][c], acc[r][c]);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < L::TM; ++r) {
    const int m = m0 + ty * L::TM + r, n = n0 + tx * 4;
    store_pair(a, m, n, tot[r][0], tot[r][1]);
    store_pair(a, m, n + 2, tot[r][2], tot[r][3]);
  }
  if (a.counters != nullptr) {
    combine_if_last<float, SIMT_THREADS>(a, m0, n0, BM, L::BN, tid);
  }
}

// The three-pass TF32 core (an fp32 weight under fp32 x). Warp (wm, wn)
// owns MT m16 tiles from row wm * MT * 16 and NT n8 tiles from column
// wn * NT * 8. Each k8 step: the x fragments (two k of a row: one 8-byte
// load) and the weight fragments (k 2 t and 2 t + 1 of column g) are
// split into TF32 hi and lo in registers, and mma_3xtf32 adds each
// (m16, n8) product to the k tile's partial on the tensor cores; after the
// tile's 4 k8 steps the partial is added to the split's sum in fp32. An
// output's sum runs over the k tiles in order within each split, and the
// splits' sums are added in order, whatever the row tile: row i of an
// M-row call is the 1-row call's.
template <int BM>
__global__ void __launch_bounds__(SIMT_THREADS, Tf32Tile<BM>::MIN_BLOCKS)
tf32_gemm(const GemmArgs a, const int route) {
  using L = Tf32Tile<BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* tot_s = reinterpret_cast<float*>(smem + L::STAGES * L::STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * L::BN;
  const int ktiles = (a.K + L::BK - 1) / L::BK;
  const bool serial = a.combine == COMBINE_SERIAL;
  const int s_lo = serial ? 0 : (int)blockIdx.z;
  const int s_hi = serial ? a.splits : s_lo + 1;
  const int kt_lo = split_start(s_lo, ktiles, a.splits);
  const int nkt = split_start(s_hi, ktiles, a.splits) - kt_lo;

#pragma unroll
  for (int p = 0; p < L::STAGES - 1; ++p) {
    if (p < nkt) gemm_stage<W_FP, L>(smem + p * L::STAGE_BYTES, a, m0, n0,
                                     kt_lo + p, route, tid);
    cp_async_commit();
  }
  float acc[L::MT][L::NT][4];                 // this split's sum
  int i = 0;
  for (int sp = s_lo; sp < s_hi; ++sp) {
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;
    const int kt_end = split_start(sp + 1, ktiles, a.splits);
    for (int kt = split_start(sp, ktiles, a.splits); kt < kt_end; ++kt, ++i) {
      cp_async_wait<L::STAGES - 2>();
      __syncthreads();
      const int nx = i + L::STAGES - 1;
      if (nx < nkt) gemm_stage<W_FP, L>(smem + (nx % L::STAGES) * L::STAGE_BYTES,
                                        a, m0, n0, kt_lo + nx, route, tid);
      cp_async_commit();
      const uint8_t* st = smem + (i % L::STAGES) * L::STAGE_BYTES;
      const float* xs = reinterpret_cast<const float*>(st) +
                        (wm * L::MT * 16 + g) * L::XLD + 2 * t;
      const float* ws = reinterpret_cast<const float*>(st + L::X_BYTES) +
                        2 * t * L::WLD + wn * L::NT * 8 + g;
      float part[L::MT][L::NT][4];            // this k tile's partial
#pragma unroll
      for (int kk = 0; kk < L::BK / 8; ++kk) {
        uint32_t ah[L::MT][4], al[L::MT][4];
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt) {
          const float* xr = xs + mt * 16 * L::XLD + kk * 8;
          const float2 u = *reinterpret_cast<const float2*>(xr);
          const float2 v = *reinterpret_cast<const float2*>(xr + 8 * L::XLD);
          split_tf32(u.x, ah[mt][0], al[mt][0]);     // (g, 2 t)
          split_tf32(v.x, ah[mt][1], al[mt][1]);     // (g + 8, 2 t)
          split_tf32(u.y, ah[mt][2], al[mt][2]);     // (g, 2 t + 1)
          split_tf32(v.y, ah[mt][3], al[mt][3]);     // (g + 8, 2 t + 1)
        }
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) {
          const float* wc = ws + kk * 8 * L::WLD + nt * 8;
          uint32_t bh[2], bl[2];
          split_tf32(wc[0], bh[0], bl[0]);           // (2 t, g)
          split_tf32(wc[L::WLD], bh[1], bl[1]);      // (2 t + 1, g)
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt) {
            mma_3xtf32(part[mt][nt], ah[mt], al[mt], bh, bl, kk == 0);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) add_rn(acc[mt][nt], part[mt][nt]);
    }
    // the split's sum into the block's total, in split order
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* tp = tot_s + ((mt * L::NT + nt) * 4 + c) * SIMT_THREADS + tid;
          *tp = sp == s_lo ? acc[mt][nt][c] : __fadd_rn(*tp, acc[mt][nt][c]);
        }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt) {
      const float* tp = tot_s + (mt * L::NT + nt) * 4 * SIMT_THREADS + tid;
      const float r[4] = {tp[0], tp[SIMT_THREADS], tp[2 * SIMT_THREADS],
                          tp[3 * SIMT_THREADS]};
      const int m = m0 + (wm * L::MT + mt) * 16 + g;
      const int n = n0 + (wn * L::NT + nt) * 8 + 2 * t;
      store_pair(a, m, n, r[0], r[1]);
      store_pair(a, m + 8, n, r[2], r[3]);
    }
  }
  if (a.counters != nullptr) {
    combine_if_last<float, SIMT_THREADS>(a, m0, n0, BM, L::BN, tid);
  }
}

// ------------------------------------------------------------------ host
// A 2-D row-major [rows, cols] tensor map with boxes of box_cols x box_rows.
bool encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType dt,
               int elem_bytes, int rows, int cols, int box_cols, int box_rows,
               CUtensorMapSwizzle swizzle) {
  EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, dt, 2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks a launch plan of bm x bn x bk tiles: one split goes with
// COMBINE_NONE and only with it; the partial buffer is given exactly when
// the splits run apart ("blocks", "pass"), the tile counts exactly for
// "blocks", whose output tiles must each have one. Returns 0 or
// cudaErrorInvalidValue.
int check_plan(const GemmArgs& a, int bm, int bn, int bk, int route) {
  const int ktiles = (a.K + bk - 1) / bk;
  const bool blocks = a.combine == COMBINE_BLOCKS;
  const bool apart = blocks || a.combine == COMBINE_PASS;
  const long long tiles = (long long)((a.M + bm - 1) / bm) * ((a.N + bn - 1) / bn);
  if (a.M <= 0 || a.N <= 0 || a.K < 0 || a.act < 0 || a.act > 2 ||
      a.splits < 1 || a.splits > (ktiles > 1 ? ktiles : 1) ||
      a.splits > 65535 || a.combine < COMBINE_NONE ||
      a.combine > COMBINE_PASS ||
      (a.combine == COMBINE_NONE) != (a.splits == 1) ||
      (route != ROUTE_FAST && route != ROUTE_PLAIN) ||
      (a.partial != nullptr) != apart || (a.counters != nullptr) != blocks ||
      (blocks && tiles > COUNTERS)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

constexpr size_t SUM_BLOCKS = 16 * 132;   // 16 blocks an SM of an H100
template <typename OutT>
void launch_split_sum(const GemmArgs& a, cudaStream_t st) {
  if (a.combine != COMBINE_PASS) return;
  size_t blocks = ((size_t)a.M * a.N + 255) / 256;
  if (blocks > SUM_BLOCKS) blocks = SUM_BLOCKS;
  split_sum<OutT><<<(unsigned)blocks, 256, 0, st>>>(a);
}

template <int WK, int NC>
int launch_tc(const CUtensorMap& tx, const CUtensorMap& tw, GemmArgs a,
              int route, cudaStream_t st) {
  using L = TcTile<WK, NC>;
  int err = check_plan(a, L::BM, TC_BN, TC_BK, route);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(tc_gemm<WK, NC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  L::SMEM_BYTES);
  if (err) return err;
  const dim3 grid((a.M + L::BM - 1) / L::BM, (a.N + TC_BN - 1) / TC_BN,
                  a.partial != nullptr ? a.splits : 1);
  tc_gemm<WK, NC><<<grid, L::THREADS, L::SMEM_BYTES, st>>>(tx, tw, a, route);
  launch_split_sum<__nv_bfloat16>(a, st);
  return (int)cudaGetLastError();
}

// bf16 x: the tensor-core core, row tiles of block_m = 64 or 128. Returns
// a cudaError_t code.
template <int WK>
int run_tc(GemmArgs a, int block_m, int route, cudaStream_t st) {
  a.ldp = (a.N + 3) & ~3;
  if (a.M <= 0 || a.N <= 0 || (a.N + TC_BN - 1) / TC_BN > 65535 ||
      (block_m != 64 && block_m != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = block_m / 64;
  CUtensorMap tx, tw;
  memset(&tx, 0, sizeof(tx));
  memset(&tw, 0, sizeof(tw));
  if (route == ROUTE_FAST) {
    const int wal = WK == W_FP ? 8 : 16;     // elements per 16 bytes
    const int kq = WK == W_INT4 ? (a.K + 1) / 2 : a.K;
    if (a.K <= 0 || a.K % 8 != 0 || a.N % wal != 0 || !aligned16(a.x) ||
        !aligned16(a.w)) {
      return (int)cudaErrorInvalidValue;     // the plan must take plain loads
    }
    bool ok = encode_2d(&tx, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.M,
                        a.K, 64, 64 * nc, CU_TENSOR_MAP_SWIZZLE_128B);
    if (WK == W_FP) {
      ok = ok && encode_2d(&tw, a.w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.K,
                           a.N, 64, TC_BK, CU_TENSOR_MAP_SWIZZLE_128B);
    } else {
      ok = ok && encode_2d(&tw, a.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kq,
                           a.N, TC_BN, WK == W_INT8 ? TC_BK : TC_BK / 2,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  return nc == 2 ? launch_tc<WK, 2>(tx, tw, a, route, st)
                 : launch_tc<WK, 1>(tx, tw, a, route, st);
}

template <int WK, int BM>
int launch_simt(GemmArgs a, int route, cudaStream_t st) {
  using L = SimtTile<WK, BM>;
  int err = check_plan(a, BM, L::BN, L::BK, route);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      simt_gemm<WK, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM_BYTES);
  if (err) return err;
  const int tiles_n = (a.N + L::BN - 1) / L::BN;
  if (tiles_n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.M + BM - 1) / BM, tiles_n,
                  a.partial != nullptr ? a.splits : 1);
  simt_gemm<WK, BM><<<grid, SIMT_THREADS, L::SMEM_BYTES, st>>>(a, route);
  launch_split_sum<float>(a, st);
  return (int)cudaGetLastError();
}

// fp32 x, an int8 or int4 weight: the CUDA-core core, row tiles of
// block_m = 8 or 64.
template <int WK>
int run_simt(GemmArgs a, int block_m, int route, cudaStream_t st) {
  a.ldp = (a.N + 3) & ~3;
  if (route == ROUTE_FAST) {
    if (a.K % 4 != 0 || a.N % 16 != 0 || !aligned16(a.x) || !aligned16(a.w)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (block_m == 8) return launch_simt<WK, 8>(a, route, st);
  if (block_m == 64) return launch_simt<WK, 64>(a, route, st);
  return (int)cudaErrorInvalidValue;
}

template <int BM>
int launch_tf32(GemmArgs a, int route, cudaStream_t st) {
  using L = Tf32Tile<BM>;
  int err = check_plan(a, BM, L::BN, L::BK, route);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      tf32_gemm<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM_BYTES);
  if (err) return err;
  const int tiles_n = (a.N + L::BN - 1) / L::BN;
  if (tiles_n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.M + BM - 1) / BM, tiles_n,
                  a.partial != nullptr ? a.splits : 1);
  tf32_gemm<BM><<<grid, SIMT_THREADS, L::SMEM_BYTES, st>>>(a, route);
  launch_split_sum<float>(a, st);
  return (int)cudaGetLastError();
}

// fp32 x and an fp32 weight: the three-pass TF32 core, row tiles of
// block_m = 16, 64 or 128.
inline int run_tf32(GemmArgs a, int block_m, int route, cudaStream_t st) {
  a.ldp = (a.N + 3) & ~3;
  if (route == ROUTE_FAST) {
    if (a.K % 4 != 0 || a.N % 4 != 0 || !aligned16(a.x) || !aligned16(a.w)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (block_m == 16) return launch_tf32<16>(a, route, st);
  if (block_m == 64) return launch_tf32<64>(a, route, st);
  if (block_m == 128) return launch_tf32<128>(a, route, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
