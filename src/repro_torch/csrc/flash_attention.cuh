// flash_attention.cuh: prefill self-attention with an online softmax, for
// Hopper (sm_90a): the kernels and their host launchers, shared by the
// sources that compile them apart (see flash_attention.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// launched by flash_attention). It computes the same function with the
// generality the port's prefill needs; it is not a block-by-block copy of
// the Pallas grid.
//
//   q [B, S, H, hd], k [B, S, KV, hd] and v [B, S, KV, dv] (the
//   projections' layout, one dtype, fp32 or bf16); q_pos [B, S] int32 ->
//   out [B, S, H, dv] in q's dtype. The value head dim may differ from the
//   query-key one: deepseek-v2's Multi-head Latent Attention scores at 192
//   (128 + a 64-wide RoPE part) and reads values of 128.
//
// Semantics (those of the port's models/attention.py::online_attention
// with no kv_valid_len): key j (its index) attends to a query at position
// p = q_pos[b, i] iff, when causal, j <= p, p - j < window and, with a
// chunk (llama4's block-local iRoPE layers; the TPU kernel has no such
// mask), p / chunk == j / chunk; a non-causal call attends to every key
// and takes no window and no chunk (the entry refuses them: the TPU
// kernel would window it, online_attention would not). Query head h
// reads KV head h / (H / KV) directly: no repeated K/V copies. A score is q.k * scale, then the softcap (cap * tanh(s / cap)),
// then the mask, whose value is the finite NEG_INF = -0.7 * f32max; the
// softmax runs online over KV tiles with the running (m, l, acc) in fp32
// and l clamped at 1e-30 at the end. S need not be a multiple of any
// tile: keys j >= S are masked in the kernel.
//
// Block skip, as the TPU kernel's, taken from q_pos: a block visits only
// the KV tiles that hold a key some of its rows may attend to, the tiles
// from the one holding min(q_pos) - window + 1 (or, with a chunk, the
// first key of min(q_pos)'s chunk, if that is later) up to the one
// holding max(q_pos). A skipped tile would add exp(NEG_INF - m) = 0 to every row,
// so the result is that of the unskipped scan for every row that has a
// key to attend to (any row with 0 <= q_pos < S). No split over keys and
// no atomics: a row's output depends on its batch row alone, so a B-row
// call gives each row the bits of a 1-row call, and swapped and unswapped
// passes agree bitwise.
//
// What bounds it on an H100: operations, 2 (hd + dv) flops per (query,
// key, head) pair that is not skipped, against reading q, k, v once and
// writing out once. Three kernels, chosen by the caller from (dtype, hd, dv)
// (kernels/flash_attention.py::path), never as a reaction to a failure:
//
// * fa_tc, bf16 at every (hd, dv) with hd and dv multiples of 8 (TMA's
//   16-byte row stride), at most 256, whose widths rounded up to 64, the
//   template's (HD, HDV), are (64, 64), (128, 128), (256, 256) or
//   (192, 128): every bf16 prefill of the port's configs (hd 64, 80, 112,
//   120, 128, 256; MLA's (192, 128)). The tensor cores.
//   One block per (128 query rows, query head, batch row): two consumer
//   warpgroups of 64 rows and a producer warpgroup whose one thread issues
//   the TMA loads: Q once, then K and V tiles of 64 keys into a ring of
//   stages (2 at HD 256, where Q and one stage take 64 KB each, 3 below:
//   at (192, 128) Q takes 48 KB and a stage 24 + 16 KB), each with its own
//   mbarrier so the scores start when K lands. Q and K are HD / 64 boxes
//   of 64 columns and V HDV / 64, each read at its own width (no padding
//   of V to hd). The tensor maps are 4-D (head dim, head, S, batch) at
//   the real hd and dv, so TMA zero-fills a box's columns at or past hd
//   (dv): a padded Q or K column adds exactly 0 to a score and a padded V
//   column gives an output column that is never stored; nothing is padded
//   or copied in device memory, and the scale is the caller's. Q K^T runs
//   KSTEPS = ceil(hd / 16) k16 steps (a template parameter: 5 at hd 80, 7
//   at 112, 8 at 120), dropping those that would read only zero columns;
//   P V runs at HDV; the store writes the dv real columns at row stride
//   dv. A box never reads the next batch row past S (TMA zero-fills
//   there) and keys j >= S are masked explicitly. S = Q K^T is wgmma
//   m64n64k16 with both operands in shared memory (K is the K-major B);
//   scale, softcap (tanh.approx.f32, within the bf16 tolerance), mask
//   (skipped on tiles every row attends to whole) and the online-softmax
//   update run on the fp32 accumulator in registers, the row max and sum
//   over the 4 threads that share a row (quad shuffles). P is rounded to bf16 in registers and is
//   the register A operand of O += P V (wgmma m64n{dv}k16, V the MN-major
//   B with the transpose flag, as sm90_gemm.cuh's weight operand). At dv
//   256 O is 128 fp32 registers a thread; setmaxnreg gives the consumers
//   232 registers and the producer 40. GQA: the G query heads of a KV head
//   are neighbouring blocks (blockIdx.x is the head), so they run together
//   and read the same K / V tiles, the second and later reads from L2 (a
//   gemma2-9b layer's K and V, 34 MB at 4,200 tokens, fit its 50 MB);
//   folding the G heads into one block's rows would save those L2 reads
//   but tie the block's row count to G. Causal blocks run the longest
//   query tiles first.
// * fa_tf32, fp32 at every (hd, dv) of multiples of 4 whose widths rounded
//   up to 64 are (64, 64) or (128, 128): qwen's and granite-20b's 128,
//   h2o-danube's 120, zamba2's 112 and the reduced configs' 64. The tensor
//   cores in three-pass TF32 (sm90_common.cuh: each operand split into
//   TF32 hi and lo, hi lo + lo hi + hi hi into fp32 accumulators), within
//   1e-5 of the plain version, where one TF32 pass would not be. One block
//   of 256 threads per (128 query rows, query head, batch row), as fa_tc's;
//   each warp owns 16 rows and runs mma.sync.m16n8k8. Q is staged once as
//   fp32 (rows of HD + 8 floats) and split in registers. K / V tiles of 32
//   keys land by 16-byte cp.async into two stages (plain loads where k or
//   v is not 16-byte aligned; columns past hd and dv stay zero), and the
//   block splits each landed tile once into TF32 hi and lo tiles in shared
//   memory, which every warp then reads: eight warps no longer split the
//   same K and V. Q K^T takes ceil(hd / 8) k8 steps, reading Q and K
//   fragments as 8-byte pairs (the k8 step's k 2 t and 2 t + 1 placed at
//   the instruction's t and t + 4, the same for both operands), each 32 of
//   hd summed on the tensor cores and then added in fp32; the scores'
//   accumulator is then, in that order, P's A fragment for P V, so P never
//   leaves registers; V is read as it lies, keys 2 t and 2 t + 1 of a
//   column (rows of HDV + 4 words, free of bank conflicts), so nothing is
//   transposed, as wgmma's K-major TF32 operand would need; each n8 group
//   of O is summed over a tile's keys on the tensor cores, then added in
//   fp32. Scale, softcap (tanhf, fp32-accurate: tanh.approx holds only the
//   bf16 tolerance), mask and the online softmax (expf) run in fp32 on the
//   accumulator, row max and sum over the 4 threads of a row. 8-key groups
//   past the block's last attended key and n8 groups of O past dv are
//   skipped. Shared memory at (128, 128): Q 68 KB, two landed stages of 32
//   KB and the split tile 67 KB; with wgmma, Q's hi and lo tiles alone
//   would take 64 KB at 64 rows.
// * fa_simt, fp32 at any other pair (deepseek's (192, 128), hd 256, an hd
//   or dv that is no multiple of 4) and bf16 at any pair outside fa_tc's
//   rule (an hd or dv that is no multiple of 8, or widths rounding up to
//   another pair, such as (128, 192)): the CUDA cores in
//   fp32, hd and dv each rounded up to a template width of 64, 128 or 256.
//   One block of 256 threads per (32 (query, head) rows of one KV head's G
//   heads, KV head, batch row), so each K / V tile is staged once for all
//   G heads. K / V tiles of 64 keys (32 where hd or dv > 128) arrive by
//   16-byte cp.async into two stages while the block computes the tile
//   before (plain loads where rows are not 16-byte aligned). Each thread
//   owns 2 rows x tile / 16 keys of the scores (float4 reads of Q and K),
//   computes each score's tanh and exp once, and then those rows x dv / 16
//   columns of the output, with P passed through shared memory. Keys past
//   the block's last attended key are skipped, and the mask is skipped on
//   tiles every row attends to whole. Two barriers a tile.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "sm90_common.cuh"

namespace {

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int PATH_TC = 0;        // kernels/flash_attention.py PATHS
constexpr int PATH_SIMT = 1;
constexpr int PATH_TF32 = 2;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the smallest and largest of the block's real rows' positions (every
// thread passes its value or INT32_MAX / INT32_MIN); all threads get both
template <int THREADS>
__device__ __forceinline__ void block_minmax(int& lo, int& hi, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32] = lo;
    red[THREADS / 32 + threadIdx.x / 32] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[THREADS / 32 + w]);
  }
}

// the keys [kv_lo, kv_hi) that hold every key a row with a position in
// [lo, hi] may attend to (chunk > 0 only on a causal call)
__device__ __forceinline__ void key_range(int lo, int hi, int S, int causal,
                                          int window, int chunk, int& kv_lo,
                                          int& kv_hi) {
  kv_lo = 0;
  kv_hi = S;
  if (causal) {
    kv_hi = (int)min((long long)S, (long long)hi + 1);
    if (window > 0) kv_lo = (int)max(0LL, (long long)lo - window + 1);
    if (chunk > 0 && lo > 0) kv_lo = max(kv_lo, lo / chunk * chunk);
  }
  if (kv_hi < kv_lo) kv_hi = kv_lo;
}

// every row with a position in [lo, hi] attends to every key of [j0, j1);
// a causal true needs j1 - 1 <= lo, so lo, hi, j0 >= 0 in the chunk test
__device__ __forceinline__ bool all_attend(int j0, int j1, int lo, int hi,
                                           int S, int causal, int window,
                                           int chunk) {
  if (j1 > S) return false;
  if (!causal) return true;
  return j1 - 1 <= lo && (window <= 0 || (long long)hi - j0 < window) &&
         (chunk <= 0 || j0 / chunk == hi / chunk);
}

// j <= qp comes first, so qp >= j >= 0 in the chunk test
__device__ __forceinline__ bool attends(int j, int qp, int S, int causal,
                                        int window, int chunk) {
  if (j >= S) return false;
  if (!causal) return true;
  return j <= qp && (window <= 0 || qp - j < window) &&
         (chunk <= 0 || j / chunk == qp / chunk);
}

// ------------------------------------------------------ tensor-core kernel
// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], both operands K-major in
// shared memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers (four bf16
// pairs a thread, the layout of an m64n16 accumulator's rows), B MN-major
// in shared memory (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: A from registers (four bf16
// pairs a thread, the layout of an m64n16 accumulator's rows), B MN-major
// in shared memory (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] * B[16 x 256]: A from registers (four bf16
// pairs a thread, the layout of an m64n16 accumulator's rows), B MN-major
// in shared memory (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int HDV>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDV / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HDV == 64) {
    wgmma_rs_m64n64k16(o, a, db);
  } else if constexpr (HDV == 128) {
    wgmma_rs_m64n128k16(o, a, db);
  } else {
    wgmma_rs_m64n256k16(o, a, db);
  }
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

constexpr int TC_BQ = 128;            // query rows a block
constexpr int TC_BKV = 64;            // keys a K / V tile
constexpr int TC_THREADS = 384;       // two consumer warpgroups + producer
constexpr int TC_BOX = 64 * 128;      // one 64-row, 128-byte-swizzled box

// (HD, HDV): the widths, multiples of 64, that a bf16 (hd, dv) rounds up to
template <int HD, int HDV> struct TcAttn {
  static constexpr int NB = HD / 64;                // Q / K 64-column boxes
  static constexpr int NBV = HDV / 64;              // V 64-column boxes
  static constexpr int STAGES = HD == 256 ? 2 : 3;
  static constexpr int Q_BYTES = TC_BQ * HD * 2;    // NB boxes of 128 rows
  static constexpr int K_BYTES = TC_BKV * HD * 2;   // NB boxes of 64 rows
  static constexpr int V_BYTES = TC_BKV * HDV * 2;  // NBV boxes of 64 rows
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;  // K, then V
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // + the mbarriers (Q; K, V and empty per stage) + slack to align to 1 KB
  static constexpr int SMEM_BYTES = BAR_OFF + (1 + 3 * STAGES) * 8 + 1024;
  static_assert(HD % 64 == 0 && HDV % 64 == 0 && HDV <= 256, "64-col boxes");
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
};

// KSTEPS = ceil(hd / 16): the k16 steps of Q K^T that read a real column
template <int HD, int HDV, int KSTEPS>
__global__ void __launch_bounds__(TC_THREADS, 1)
fa_tc(const __grid_constant__ CUtensorMap tm_q,
      const __grid_constant__ CUtensorMap tm_k,
      const __grid_constant__ CUtensorMap tm_v,
      const int32_t* __restrict__ q_pos, __nv_bfloat16* __restrict__ out,
      int S, int H, int KV, int dv, float scale, int causal, int window,
      int chunk, float softcap) {
  using L = TcAttn<HD, HDV>;
  static_assert(KSTEPS > HD / 16 - 4 && KSTEPS <= HD / 16,
                "an hd that rounds up to HD");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + L::Q_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + L::STAGES;
  uint64_t* empty = vfull + L::STAGES;
  __shared__ int red[2 * TC_THREADS / 32];

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  // causal: the query tiles with the most keys first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = qt * TC_BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int lo = INT32_MAX, hi = INT32_MIN;
  if (tid < TC_BQ && m0 + tid < S) {
    lo = hi = q_pos[(size_t)b * S + m0 + tid];
  }
  block_minmax<TC_THREADS>(lo, hi, red);     // its barrier publishes the init
  int kv_lo, kv_hi;
  key_range(lo, hi, S, causal, window, chunk, kv_lo, kv_hi);
  const int t_lo = kv_lo / TC_BKV;
  const int ntiles = (kv_hi + TC_BKV - 1) / TC_BKV - t_lo;

  if (tid >= 256) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 256) {
      mbar_expect_tx(qfull, L::Q_BYTES);
      for (int c = 0; c < L::NB; ++c) {
        tma_load_4d(smem + c * 2 * TC_BOX, &tm_q, qfull, c * 64, h, m0, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % L::STAGES;
        const int j0 = (t_lo + i) * TC_BKV;
        mbar_wait(&empty[s], ((i / L::STAGES) & 1) ^ 1);
        uint8_t* ks = ring + s * L::STAGE_BYTES;
        mbar_expect_tx(&kfull[s], L::K_BYTES);
        for (int c = 0; c < L::NB; ++c) {
          tma_load_4d(ks + c * TC_BOX, &tm_k, &kfull[s], c * 64, kvh, j0, b);
        }
        mbar_expect_tx(&vfull[s], L::V_BYTES);
        for (int c = 0; c < L::NBV; ++c) {
          tma_load_4d(ks + L::K_BYTES + c * TC_BOX, &tm_v, &vfull[s],
                      c * 64, kvh, j0, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  // this thread's two rows and its columns 2 (lane % 4) + {0, 1} of every
  // 8-column group of an accumulator
  const int row_a = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  const int qp_a = row_a < S ? q_pos[(size_t)b * S + row_a] : 0;
  const int qp_b = row_b < S ? q_pos[(size_t)b * S + row_b] : 0;
  const int col = 2 * (lane & 3);
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;

  float o[HDV / 2];
#pragma unroll
  for (int e = 0; e < HDV / 2; ++e) o[e] = 0.0f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;
  const uint32_t qa = smem_u32(smem) + wg * (64 * 128);
  mbar_wait(qfull, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % L::STAGES;
    const uint32_t phase = (i / L::STAGES) & 1;
    const int j0 = (t_lo + i) * TC_BKV;
    const uint32_t ka = smem_u32(ring + s * L::STAGE_BYTES);
    const uint32_t va = ka + L::K_BYTES;

    // S = Q K^T: K-major operands, k16 steps 32 bytes into a box's rows;
    // the steps past KSTEPS would add only TMA's zero columns
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
    mbar_wait(&kfull[s], phase);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t k16 = (kk & 3) * 32;
      wgmma_ss_m64n64k16(
          sc, sw128_desc(qa + (kk >> 2) * 2 * TC_BOX + k16, 16, 1024),
          sw128_desc(ka + (kk >> 2) * TC_BOX + k16, 16, 1024), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(sc);

    // scale, softcap (tanh.approx: within the bf16 tolerance), mask
    // unless every row attends to the whole tile; register 4 j + q holds
    // row (q < 2 ? a : b), key j0 + 8 j + col + q % 2
    const bool full =
        all_attend(j0, j0 + TC_BKV, lo, hi, S, causal, window, chunk);
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float x = sc[4 * j + q] * scale;
        if (softcap > 0.0f) x = softcap * tanh_approx(x * inv_cap);
        if (!full && !attends(j0 + 8 * j + col + (q & 1), q < 2 ? qp_a : qp_b,
                              S, causal, window, chunk)) {
          x = NEG_INF;
        }
        sc[4 * j + q] = x;
        if (q < 2) {
          mx_a = fmaxf(mx_a, x);
        } else {
          mx_b = fmaxf(mx_b, x);
        }
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = __expf(m_a - mn_a), corr_b = __expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = __expf(sc[e] - ((e & 2) ? mn_b : mn_a));
      sc[e] = p;
      if (e & 2) {
        ps_b += p;
      } else {
        ps_a += p;
      }
    }
    l_a = l_a * corr_a + ps_a;       // this thread's share of the row sum
    l_b = l_b * corr_b + ps_b;
#pragma unroll
    for (int e = 0; e < HDV / 2; ++e) o[e] *= (e & 2) ? corr_b : corr_a;
    // P as the A operand: k16 step kk covers keys 16 kk .. 16 kk + 15,
    // registers 8 kk .. 8 kk + 7 of the scores, already in A's layout
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      }
    }

    // O += P V: V MN-major, 8-key groups 1 KB apart, boxes TC_BOX apart
    mbar_wait(&vfull[s], phase);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<HDV>(o, pa[kk], sw128_desc(va + kk * 2048, TC_BOX, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  // the dv real columns at row stride dv: 8-column group j holds a real
  // column iff j < dv / 8 (dv is a multiple of 8, so a bf16x2 stays aligned)
  const int ngroups = dv / 8;
#pragma unroll
  for (int j = 0; j < HDV / 8; ++j) {
    const int c = 8 * j + col;
    if (j < ngroups && row_a < S) {
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * S + row_a) * H + h) * dv + c) =
          __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    }
    if (j < ngroups && row_b < S) {
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * S + row_b) * H + h) * dv + c) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
  }
}

// -------------------------------------------------------- CUDA-core kernel
constexpr int ST_THREADS = 256;

constexpr int ST_BR = 32;           // (query, head) rows a block
constexpr int ST_RT = ST_BR / 16;   // rows a thread

template <typename T, int HD, int HDV> struct SimtAttn {
  static constexpr int BK = HD > 128 || HDV > 128 ? 32 : 64;  // keys a tile
  static constexpr int VEC = 16 / sizeof(T);         // elements per 16 bytes
  static constexpr int LD = HD + VEC;                // K row stride
  static constexpr int LDV = HDV + VEC;              // V row stride
  static constexpr int QLD = HD + 4;                 // fp32 Q row stride
  static constexpr int PLD = ST_BR + 4;              // fp32 P^T row stride
  static constexpr int KC = BK / 16;                 // keys a thread
  static constexpr int DC = HDV / 64;                // float4 columns a thread
  static constexpr int Q_BYTES = ST_BR * QLD * 4;
  static constexpr int K_TILE = BK * LD;             // elements of a K tile
  static constexpr int STAGE = K_TILE + BK * LDV;    // K, then V
  static constexpr int STAGE_BYTES = STAGE * (int)sizeof(T);
  static constexpr int P_BYTES = BK * PLD * 4;
  // Q, two stages of K and V, P^T
  static constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGE_BYTES + P_BYTES;
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &u.x, 4);
  memcpy(&b, &u.y, 4);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

// Keys j0 .. j0 + BK - 1 of one tensor (K at width n = hd, or V at n = dv)
// into a stage's tile of row stride ld: 16-byte cp.async where rows are
// 16-byte aligned (vec), else plain loads; zeros past S. Columns past n
// are never written (zero since the block began).
template <typename T, int BK>
__device__ __forceinline__ void simt_rows(T* dst, int ld, const T* src,
                                          int b, int S, int KV, int kvh,
                                          int n, int j0, bool vec, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    const int rv = n / VEC;
    for (int e = tid; e < BK * rv; e += ST_THREADS) {
      const int r = e / rv, c = (e % rv) * VEC;
      const bool ok = j0 + r < S;
      const size_t off =
          (((size_t)b * S + (ok ? j0 + r : 0)) * KV + kvh) * n + c;
      cp_async16(dst + r * ld + c, src + off, ok);
    }
  } else {
    for (int e = tid; e < BK * n; e += ST_THREADS) {
      const int r = e / n, c = e % n;
      T x = from_f<T>(0.0f);
      if (j0 + r < S) x = src[(((size_t)b * S + j0 + r) * KV + kvh) * n + c];
      dst[r * ld + c] = x;
    }
  }
}

template <typename T, int HD, int HDV>
__device__ __forceinline__ void simt_tile(T* stage, const T* k, const T* v,
                                          int b, int S, int KV, int kvh,
                                          int hd, int dv, int j0, bool vec,
                                          int tid) {
  using L = SimtAttn<T, HD, HDV>;
  simt_rows<T, L::BK>(stage, L::LD, k, b, S, KV, kvh, hd, j0, vec, tid);
  simt_rows<T, L::BK>(stage + L::K_TILE, L::LDV, v, b, S, KV, kvh, dv, j0,
                      vec, tid);
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(ST_THREADS, 1)
fa_simt(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const int32_t* __restrict__ q_pos,
        T* __restrict__ out, int S, int H, int KV, int hd, int dv,
        float scale, int causal, int window, int chunk, float softcap,
        int vec) {
  using L = SimtAttn<T, HD, HDV>;
  constexpr int RT = ST_RT;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* stages = reinterpret_cast<T*>(smem + L::Q_BYTES);  // K0 V0 K1 V1
  float* pt = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::STAGE_BYTES);
  __shared__ int red[2 * ST_THREADS / 32];

  const int G = H / KV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  // causal: the row tiles with the most keys first
  const int rt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int rows = S * G;         // row r: query r / G, head r % G
  const int r0 = rt * ST_BR;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  if (hd < HD || dv < HDV) {     // columns past hd / dv stay zero
    for (int e = tid; e < 2 * L::STAGE_BYTES / 16; e += ST_THREADS) {
      reinterpret_cast<uint4*>(stages)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll      // every load in flight at once: one latency, not 32
  for (int i = 0; i < ST_BR * HD / ST_THREADS; ++i) {
    const int e = tid + i * ST_THREADS;
    const int r = e / HD, c = e % HD;
    const int rr = r0 + r;
    float x = 0.0f;
    if (rr < rows && c < hd) {
      x = to_f<T>(q[(((size_t)b * S + rr / G) * H + kvh * G + rr % G) * hd +
                    c]);
    }
    qs[r * L::QLD + c] = x;
  }
  int lo = INT32_MAX, hi = INT32_MIN;
  if (tid < ST_BR && r0 + tid < rows) {
    lo = hi = q_pos[(size_t)b * S + (r0 + tid) / G];
  }
  block_minmax<ST_THREADS>(lo, hi, red);     // also publishes the zeros and Q
  int kv_lo, kv_hi;
  key_range(lo, hi, S, causal, window, chunk, kv_lo, kv_hi);
  const int t_lo = kv_lo / L::BK;
  const int ntiles = (kv_hi + L::BK - 1) / L::BK - t_lo;

  int qp[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int rr = r0 + RT * ty + r;
    qp[r] = rr < rows ? q_pos[(size_t)b * S + rr / G] : 0;
  }
  float m[RT], l[RT], acc[RT][L::DC][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < L::DC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][cc][e] = 0.0f;
  }

  if (ntiles > 0) {
    simt_tile<T, HD, HDV>(stages, k, v, b, S, KV, kvh, hd, dv, t_lo * L::BK,
                          vec, tid);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();                 // tile i is in; tile i - 1 is done
    if (i + 1 < ntiles) {
      simt_tile<T, HD, HDV>(stages + ((i + 1) & 1) * L::STAGE, k, v, b, S, KV,
                            kvh, hd, dv, (t_lo + i + 1) * L::BK, vec, tid);
      cp_async_commit();
    }
    const T* ks = stages + (i & 1) * L::STAGE;
    const T* vs = ks + L::K_TILE;
    const int j0 = (t_lo + i) * L::BK;
    const int nk = min(L::BK, kv_hi - j0);   // keys past kv_hi: skipped

    // scores of rows RT ty .. RT ty + RT - 1, keys tx + 16 c
    float s[RT][L::KC];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < L::KC; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        qv[r] = *reinterpret_cast<const float4*>(qs + (RT * ty + r) * L::QLD + d);
      }
#pragma unroll
      for (int c = 0; c < L::KC; ++c) {
        if (16 * c >= nk) break;
        const float4 kv = load4(ks + (tx + 16 * c) * L::LD + d);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          s[r][c] = fmaf(qv[r].x, kv.x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv.y, s[r][c]);
          s[r][c] = fmaf(qv[r].z, kv.z, s[r][c]);
          s[r][c] = fmaf(qv[r].w, kv.w, s[r][c]);
        }
      }
    }
    // scale, softcap, mask, online softmax: each score's tanh and exp once
    const bool full = all_attend(j0, j0 + nk, lo, hi, S, causal, window,
                                 chunk);
    float corr[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < L::KC; ++c) {
        const int j = tx + 16 * c;
        float x = NEG_INF;
        if (16 * c < nk) {
          x = s[r][c] * scale;
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          if (j >= nk ||
              (!full && !attends(j0 + j, qp[r], S, causal, window, chunk))) {
            x = NEG_INF;
          }
        }
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float mn = fmaxf(m[r], mx);
      corr[r] = expf(m[r] - mn);
      m[r] = mn;
      float ps = 0.0f;
#pragma unroll
      for (int c = 0; c < L::KC; ++c) {
        const float p = expf(s[r][c] - mn);
        s[r][c] = p;
        ps += p;
      }
      l[r] = l[r] * corr[r] + ps;    // this thread's share of the row sum
    }
#pragma unroll
    for (int c = 0; c < L::KC; ++c) {
      *reinterpret_cast<float2*>(pt + (tx + 16 * c) * L::PLD + RT * ty) =
          make_float2(s[0][c], s[1][c]);
    }
    __syncthreads();

    // acc[r][cc] (columns 4 tx + 64 cc ..) = acc * corr + P V
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int cc = 0; cc < L::DC; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][cc][e] *= corr[r];
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      const float2 pv =
          *reinterpret_cast<const float2*>(pt + kk * L::PLD + RT * ty);
      const float pr[RT] = {pv.x, pv.y};
#pragma unroll
      for (int cc = 0; cc < L::DC; ++cc) {
        const float4 vv = load4(vs + kk * L::LDV + 4 * tx + 64 * cc);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[r][cc][0] = fmaf(pr[r], vv.x, acc[r][cc][0]);
          acc[r][cc][1] = fmaf(pr[r], vv.y, acc[r][cc][1]);
          acc[r][cc][2] = fmaf(pr[r], vv.z, acc[r][cc][2]);
          acc[r][cc][3] = fmaf(pr[r], vv.w, acc[r][cc][3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    }
    const int rr = r0 + RT * ty + r;
    if (rr >= rows) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    T* o = out + (((size_t)b * S + rr / G) * H + kvh * G + rr % G) * dv;
#pragma unroll
    for (int cc = 0; cc < L::DC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * cc + e;
        if (d < dv) o[d] = from_f<T>(acc[r][cc][e] * inv);
      }
  }
}

// ------------------------------------------- three-pass TF32 kernel (fp32)
// fa_tf32: fp32 at every (hd, dv) of multiples of 4 whose widths rounded
// up to 64 are (64, 64) or (128, 128). Each warp owns 16 query rows and
// runs Q K^T and P V as mma.sync.m16n8k8 in three-pass TF32
// (sm90_common.cuh). K and V are split into TF32 hi and lo once a tile,
// by the whole block, into shared memory; Q and P are split in registers.
constexpr int T3_BQ = 128;          // query rows a block: 8 warps of 16
constexpr int T3_BKV = 32;          // keys a K / V tile

template <int HD, int HDV> struct Tf32Attn {
  // row strides in floats: HD + 8 (8 mod 32) puts the 8-byte fragment
  // loads of Q and split K (two d of one row) of a half-warp on 32 banks
  // once; HDV + 4 (4 mod 32) the 4-byte loads of split V's keys 2 t and
  // 2 t + 1 at column g. Landed K / V rows are dense (hd, dv at most HD,
  // HDV: the columns past them stay zero).
  static constexpr int LDQ = HD + 8;
  static constexpr int LDK = HD + 8;
  static constexpr int LDV = HDV + 4;
  static constexpr int Q_BYTES = T3_BQ * LDQ * 4;
  static constexpr int LAND = T3_BKV * (HD + HDV);     // floats: K, then V
  static constexpr int LAND_BYTES = LAND * 4;
  // split: K hi, K lo, V hi, V lo
  static constexpr int KS = T3_BKV * LDK, VS = T3_BKV * LDV;   // words
  static constexpr int SPLIT_BYTES = (2 * KS + 2 * VS) * 4;
  static constexpr int SMEM_BYTES = Q_BYTES + 2 * LAND_BYTES + SPLIT_BYTES;
  static_assert(HD % 64 == 0 && HDV % 64 == 0 && HD <= 128 && HDV <= 128,
                "the TF32 kernel's widths");
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
};

// one landed K / V tile split into TF32 hi and lo, by all ST_THREADS
// threads, 4 values a step
template <int HD, int HDV>
__device__ __forceinline__ void t3_split(const float* land, uint32_t* split,
                                         int tid) {
  using L = Tf32Attn<HD, HDV>;
  constexpr int KQ = HD / 4, VQ = HDV / 4;       // float4s a row
#pragma unroll
  for (int e = tid; e < T3_BKV * (KQ + VQ); e += ST_THREADS) {
    const bool isk = e < T3_BKV * KQ;
    const int f = isk ? e : e - T3_BKV * KQ;
    const int q = isk ? KQ : VQ;
    const int r = f / q, c = (f % q) * 4;
    const float4 x = *reinterpret_cast<const float4*>(
        land + (isk ? r * HD + c : T3_BKV * HD + r * HDV + c));
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    uint32_t* hi = isk ? split + r * L::LDK + c
                       : split + 2 * L::KS + r * L::LDV + c;
    *reinterpret_cast<uint4*>(hi) = h;
    *reinterpret_cast<uint4*>(hi + (isk ? L::KS : L::VS)) = l;
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(ST_THREADS, 1)
fa_tf32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const int32_t* __restrict__ q_pos,
        float* __restrict__ out, int S, int H, int KV, int hd, int dv,
        float scale, int causal, int window, int chunk, float softcap,
        int vec) {
  using L = Tf32Attn<HD, HDV>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* land = reinterpret_cast<float*>(smem + L::Q_BYTES);      // 2 stages
  uint32_t* split = reinterpret_cast<uint32_t*>(smem + L::Q_BYTES +
                                                2 * L::LAND_BYTES);
  const uint32_t* khi = split;
  const uint32_t* klo = split + L::KS;
  const uint32_t* vhi = split + 2 * L::KS;
  const uint32_t* vlo = vhi + L::VS;
  __shared__ int red[2 * ST_THREADS / 32];

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  // causal: the query tiles with the most keys first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = qt * T3_BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  if (hd < HD || dv < HDV) {     // landed columns past hd / dv stay zero
    for (int e = tid; e < 2 * L::LAND_BYTES / 16; e += ST_THREADS) {
      reinterpret_cast<uint4*>(land)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll 16
  for (int e = tid; e < T3_BQ * HD; e += ST_THREADS) {
    const int r = e / HD, c = e % HD;
    float x = 0.0f;
    if (m0 + r < S && c < hd) {
      x = q[(((size_t)b * S + m0 + r) * H + h) * hd + c];
    }
    qs[r * L::LDQ + c] = x;
  }
  int lo = INT32_MAX, hi = INT32_MIN;
  if (tid < T3_BQ && m0 + tid < S) {
    lo = hi = q_pos[(size_t)b * S + m0 + tid];
  }
  block_minmax<ST_THREADS>(lo, hi, red);     // also publishes the zeros and Q
  int kv_lo, kv_hi;
  key_range(lo, hi, S, causal, window, chunk, kv_lo, kv_hi);
  const int t_lo = kv_lo / T3_BKV;
  const int ntiles = (kv_hi + T3_BKV - 1) / T3_BKV - t_lo;

  // this thread's rows a (g) and b (g + 8) of the warp's 16, and its
  // columns 2 t, 2 t + 1 of every 8-column group of an accumulator
  const int row_a = m0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const int qp_a = row_a < S ? q_pos[(size_t)b * S + row_a] : 0;
  const int qp_b = row_b < S ? q_pos[(size_t)b * S + row_b] : 0;
  const float* qa = qs + (warp * 16 + g) * L::LDQ + 2 * t;
  const int nk8 = (hd + 7) / 8;        // k8 steps of Q K^T on a real column
  const int nd8 = (dv + 7) / 8;        // n8 tiles of O with a real column

  float o[HDV / 8][4];
#pragma unroll
  for (int nd = 0; nd < HDV / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.0f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.0f, l_b = 0.0f;

  if (ntiles > 0) {
    simt_rows<float, T3_BKV>(land, HD, k, b, S, KV, kvh, hd, t_lo * T3_BKV,
                             vec, tid);
    simt_rows<float, T3_BKV>(land + T3_BKV * HD, HDV, v, b, S, KV, kvh, dv,
                             t_lo * T3_BKV, vec, tid);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();
    __syncthreads();         // tile i landed; every warp is past tile i - 1
    t3_split<HD, HDV>(land + (i & 1) * L::LAND, split, tid);
    __syncthreads();         // tile i split
    if (i + 1 < ntiles) {    // lands while tile i is computed
      float* nl = land + ((i + 1) & 1) * L::LAND;
      const int jn = (t_lo + i + 1) * T3_BKV;
      simt_rows<float, T3_BKV>(nl, HD, k, b, S, KV, kvh, hd, jn, vec, tid);
      simt_rows<float, T3_BKV>(nl + T3_BKV * HD, HDV, v, b, S, KV, kvh, dv,
                               jn, vec, tid);
      cp_async_commit();
    }
    const int j0 = (t_lo + i) * T3_BKV;
    // 8-key groups holding a key below kv_hi: the rest are skipped
    const int nkt = (min(T3_BKV, kv_hi - j0) + 7) / 8;

    // S = Q K^T: register (nt, c) holds row (c < 2 ? a : b), key j0 + 8 nt
    // + 2 t + c % 2; each 32 of hd summed on the tensor cores, then added
    // in fp32
    float sc[T3_BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < T3_BKV / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = 0.0f;
#pragma unroll
    for (int kg = 0; kg < HD / 32; ++kg) {
      if (kg * 4 >= nk8) break;
      float p[T3_BKV / 8][4];
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int kk = kg * 4 + k4;
        if (kk >= nk8) break;
        const float2 u = *reinterpret_cast<const float2*>(qa + kk * 8);
        const float2 w = *reinterpret_cast<const float2*>(qa + 8 * L::LDQ +
                                                          kk * 8);
        uint32_t ah[4], al[4];
        split_tf32(u.x, ah[0], al[0]);
        split_tf32(w.x, ah[1], al[1]);
        split_tf32(u.y, ah[2], al[2]);
        split_tf32(w.y, ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < T3_BKV / 8; ++nt) {
          if (nt < nkt) {
            const int off = (nt * 8 + g) * L::LDK + kk * 8 + 2 * t;
            const uint2 bh2 = *reinterpret_cast<const uint2*>(khi + off);
            const uint2 bl2 = *reinterpret_cast<const uint2*>(klo + off);
            const uint32_t bh[2] = {bh2.x, bh2.y}, bl[2] = {bl2.x, bl2.y};
            mma_3xtf32(p[nt], ah, al, bh, bl, k4 == 0);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < T3_BKV / 8; ++nt) {
        if (nt < nkt) add_rn(sc[nt], p[nt]);
      }
    }

    // scale, softcap (tanhf, fp32-accurate), mask unless every row attends
    // to the whole tile; the online softmax in fp32
    const bool full =
        all_attend(j0, j0 + T3_BKV, lo, hi, S, causal, window, chunk);
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < T3_BKV / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = NEG_INF;
        if (nt < nkt) {
          x = sc[nt][c] * scale;
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          if (!full && !attends(j0 + 8 * nt + 2 * t + (c & 1),
                                c < 2 ? qp_a : qp_b, S, causal, window,
                                chunk)) {
            x = NEG_INF;
          }
        }
        sc[nt][c] = x;
        if (c < 2) {
          mx_a = fmaxf(mx_a, x);
        } else {
          mx_b = fmaxf(mx_b, x);
        }
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;
    // P split into TF32 hi / lo: key group kt's scores are the A fragment
    // as they lie (keys 2 t, 2 t + 1 at the instruction's k t, t + 4)
    uint32_t ph[T3_BKV / 8][4], pl[T3_BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < T3_BKV / 8; ++nt) {
      float pv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pv[c] = expf(sc[nt][c] - (c < 2 ? mn_a : mn_b));
        if (c < 2) {
          ps_a += pv[c];
        } else {
          ps_b += pv[c];
        }
      }
      split_tf32(pv[0], ph[nt][0], pl[nt][0]);
      split_tf32(pv[2], ph[nt][1], pl[nt][1]);
      split_tf32(pv[1], ph[nt][2], pl[nt][2]);
      split_tf32(pv[3], ph[nt][3], pl[nt][3]);
    }
    l_a = l_a * corr_a + ps_a;       // this thread's share of the row sum
    l_b = l_b * corr_b + ps_b;

    // O = O * corr + P V: each n8 group of O summed over the tile's keys
    // on the tensor cores, then added in fp32; V's keys 2 t and 2 t + 1 of
    // column g are B's
    const int vrow = 2 * t * L::LDV + g;
#pragma unroll
    for (int nd = 0; nd < HDV / 8; ++nd) {
      o[nd][0] *= corr_a;
      o[nd][1] *= corr_a;
      o[nd][2] *= corr_b;
      o[nd][3] *= corr_b;
      if (nd < nd8) {
        float p[4];
#pragma unroll
        for (int kt = 0; kt < T3_BKV / 8; ++kt) {
          if (kt < nkt) {
            const int off = kt * 8 * L::LDV + vrow + nd * 8;
            const uint32_t bh[2] = {vhi[off], vhi[off + L::LDV]};
            const uint32_t bl[2] = {vlo[off], vlo[off + L::LDV]};
            mma_3xtf32(p, ph[kt], pl[kt], bh, bl, kt == 0);
          }
        }
        add_rn(o[nd], p);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  // the dv real columns at row stride dv (dv a multiple of 4: a column
  // pair 2 t, 2 t + 1 is real whole or not at all, and 8-byte aligned)
#pragma unroll
  for (int nd = 0; nd < HDV / 8; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (c < dv && row_a < S) {
      *reinterpret_cast<float2*>(out + (((size_t)b * S + row_a) * H + h) * dv +
                                 c) =
          make_float2(o[nd][0] * inv_a, o[nd][1] * inv_a);
    }
    if (c < dv && row_b < S) {
      *reinterpret_cast<float2*>(out + (((size_t)b * S + row_b) * H + h) * dv +
                                 c) =
          make_float2(o[nd][2] * inv_b, o[nd][3] * inv_b);
    }
  }
}

// ------------------------------------------------------------------ host
// a 4-D bf16 tensor map over [B, S, heads, hd] (dims innermost first) at
// the tensor's real hd (a multiple of 8: the row stride a multiple of 16
// bytes), boxes of 64 columns x 1 head x box_rows rows x 1 batch row,
// 128-byte swizzle; a box's elements past any extent read as zeros
inline bool encode_4d(CUtensorMap* map, const void* base, int hd, int heads,
                      int S, int B, int box_rows) {
  EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int HDV, int KSTEPS>
int launch_tc(const void* q, const void* k, const void* v, const void* qpos,
              void* out, int B, int S, int H, int KV, int hd, int dv,
              float scale, int causal, int window, int chunk, float softcap,
              cudaStream_t st) {
  using L = TcAttn<HD, HDV>;
  const int qtiles = (S + TC_BQ - 1) / TC_BQ;
  if (qtiles > 65535 || !aligned16(q) || !aligned16(k) || !aligned16(v)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tq, tk, tv;
  memset(&tq, 0, sizeof(tq));
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (!encode_4d(&tq, q, hd, H, S, B, TC_BQ) ||
      !encode_4d(&tk, k, hd, KV, S, B, TC_BKV) ||
      !encode_4d(&tv, v, dv, KV, S, B, TC_BKV)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc<HD, HDV, KSTEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, qtiles, B);
  fa_tc<HD, HDV, KSTEPS><<<grid, TC_THREADS, L::SMEM_BYTES, st>>>(
      tq, tk, tv, static_cast<const int32_t*>(qpos),
      static_cast<__nv_bfloat16*>(out), S, H, KV, dv, scale, causal, window,
      chunk, softcap);
  return (int)cudaGetLastError();
}

// fa_tc at the widths (HD, HDV) that hd and dv round up to, with Q K^T's
// ceil(hd / 16) k16 steps: HD / 16 - 3 .. HD / 16 at the hd of a multiple
// of 8 that round up to HD
template <int HD, int HDV>
int run_tc(const void* q, const void* k, const void* v, const void* qpos,
           void* out, int B, int S, int H, int KV, int hd, int dv,
           float scale, int causal, int window, int chunk, float softcap,
           cudaStream_t st) {
  switch ((hd + 15) / 16 - HD / 16) {
    case 0:
      return launch_tc<HD, HDV, HD / 16>(q, k, v, qpos, out, B, S, H, KV, hd,
                                         dv, scale, causal, window, chunk,
                                         softcap, st);
    case -1:
      return launch_tc<HD, HDV, HD / 16 - 1>(q, k, v, qpos, out, B, S, H, KV,
                                             hd, dv, scale, causal, window,
                                             chunk, softcap, st);
    case -2:
      return launch_tc<HD, HDV, HD / 16 - 2>(q, k, v, qpos, out, B, S, H, KV,
                                             hd, dv, scale, causal, window,
                                             chunk, softcap, st);
    case -3:
      return launch_tc<HD, HDV, HD / 16 - 3>(q, k, v, qpos, out, B, S, H, KV,
                                             hd, dv, scale, causal, window,
                                             chunk, softcap, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int HD, int HDV>
int run_tf32(const void* q, const void* k, const void* v, const void* qpos,
             void* out, int B, int S, int H, int KV, int hd, int dv,
             float scale, int causal, int window, int chunk, float softcap,
             cudaStream_t st) {
  using L = Tf32Attn<HD, HDV>;
  const int qtiles = (S + T3_BQ - 1) / T3_BQ;
  if (qtiles > 65535 || hd % 4 != 0 || dv % 4 != 0 || hd > HD || dv > HDV ||
      hd <= HD - 64 || dv <= HDV - 64) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fa_tf32<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec = aligned16(k) && aligned16(v);
  const dim3 grid(H, qtiles, B);
  fa_tf32<HD, HDV><<<grid, ST_THREADS, L::SMEM_BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(qpos),
      static_cast<float*>(out), S, H, KV, hd, dv, scale, causal, window,
      chunk, softcap, vec);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int HDV>
int launch_simt(const void* q, const void* k, const void* v, const void* qpos,
                void* out, int B, int S, int H, int KV, int hd, int dv,
                float scale, int causal, int window, int chunk, float softcap,
                cudaStream_t st) {
  using L = SimtAttn<T, HD, HDV>;
  const long long rows = (long long)S * (H / KV);  // int in the kernel
  if (rows > 0x7fffffffLL - ST_BR || KV > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fa_simt<T, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec = (hd * (int)sizeof(T)) % 16 == 0 &&
                  (dv * (int)sizeof(T)) % 16 == 0 && aligned16(k) &&
                  aligned16(v);
  const dim3 grid((unsigned)((rows + ST_BR - 1) / ST_BR), KV, B);
  fa_simt<T, HD, HDV><<<grid, ST_THREADS, L::SMEM_BYTES, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(qpos),
      static_cast<T*>(out), S, H, KV, hd, dv, scale, causal, window, chunk,
      softcap, vec);
  return (int)cudaGetLastError();
}

// the CUDA-core kernel at the template widths hd and dv round up to
template <typename T, int HD>
int run_simt_dv(const void* q, const void* k, const void* v,
                const void* qpos, void* out, int B, int S, int H, int KV,
                int hd, int dv, float scale, int causal, int window,
                int chunk, float softcap, cudaStream_t st) {
  if (dv <= 64) {
    return launch_simt<T, HD, 64>(q, k, v, qpos, out, B, S, H, KV, hd, dv,
                                  scale, causal, window, chunk, softcap, st);
  }
  if (dv <= 128) {
    return launch_simt<T, HD, 128>(q, k, v, qpos, out, B, S, H, KV, hd, dv,
                                   scale, causal, window, chunk, softcap, st);
  }
  return launch_simt<T, HD, 256>(q, k, v, qpos, out, B, S, H, KV, hd, dv,
                                 scale, causal, window, chunk, softcap, st);
}

template <typename T>
int run_simt(const void* q, const void* k, const void* v, const void* qpos,
             void* out, int B, int S, int H, int KV, int hd, int dv,
             float scale, int causal, int window, int chunk, float softcap,
             cudaStream_t st) {
  if (hd <= 64) {
    return run_simt_dv<T, 64>(q, k, v, qpos, out, B, S, H, KV, hd, dv, scale,
                              causal, window, chunk, softcap, st);
  }
  if (hd <= 128) {
    return run_simt_dv<T, 128>(q, k, v, qpos, out, B, S, H, KV, hd, dv,
                               scale, causal, window, chunk, softcap, st);
  }
  return run_simt_dv<T, 256>(q, k, v, qpos, out, B, S, H, KV, hd, dv, scale,
                             causal, window, chunk, softcap, st);
}

}  // namespace

// The compiled entries, one source each, so that nvcc builds them in
// processes of their own, all at once (kernels/_build.py): fa_tc at each
// instantiation (flash_attention_tc64.cu, _tc128.cu, _tc256.cu,
// _tc192.cu), fa_tf32 at each (flash_attention_tf32_64.cu, _tf32_128.cu)
// and fa_simt in each dtype (flash_attention_simt_fp32.cu, _simt_bf16.cu).
// flash_attention.cu checks a call and dispatches to them. Each returns
// run_tc's (run_tf32's, run_simt's) code.
#define REPRO_FA_PARAMS                                                    \
  const void *q, const void *k, const void *v, const void *qpos,          \
      void *out, int B, int S, int H, int KV, int hd, int dv, float scale, \
      int causal, int window, int chunk, float softcap, cudaStream_t st
#define REPRO_FA_ARGS                                                      \
  q, k, v, qpos, out, B, S, H, KV, hd, dv, scale, causal, window, chunk,   \
      softcap, st

extern "C" {
int repro_fa_tc_64_64(REPRO_FA_PARAMS);
int repro_fa_tc_128_128(REPRO_FA_PARAMS);
int repro_fa_tc_256_256(REPRO_FA_PARAMS);
int repro_fa_tc_192_128(REPRO_FA_PARAMS);
int repro_fa_tf32_64_64(REPRO_FA_PARAMS);
int repro_fa_tf32_128_128(REPRO_FA_PARAMS);
int repro_fa_simt_fp32(REPRO_FA_PARAMS);
int repro_fa_simt_bf16(REPRO_FA_PARAMS);
}
