// wkv6: the chunked RWKV6 (Finch) recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py (wkv6, body _kernel),
// whose chunk body is the one the rwkv6 time-mix runs on every prefill
// (src/repro/models/ssm.py, rwkv6_time_mix_chunked).
//
//   r, k, v, w_log [BH, S, hd] (fp32 or bf16); u [BH, hd] (their dtype);
//   s0 [BH, hd, hd] fp32 or null (zeros) -> y [BH, S, hd] in r's dtype and
//   s_out [BH, hd, hd] fp32, the state after the last step.
//
// The sequence runs in chunks of Q = min(16, S) steps (S % Q == 0). Per
// chunk, in fp32 whatever the input type, with l = cumsum(w_log) over the
// chunk and lprev = l - w_log:
//   y = tril_-1((r e^lprev)(k e^-l)^T) v + (sum_c r u k) v + (r e^lprev) S
//   S <- e^{l_Q} S + (k e^{l_Q - l})^T v
// w_log is clamped to [-5, -1e-4] by the caller, so e^-l reaches about
// e^80 at Q = 16: finite in fp32, and the reason for expf (not __expf).
//
// Translation: the TPU grid (BH, S / Q) runs the chunk axis in order and
// carries S in VMEM scratch from one grid step to the next, starting from
// zeros and dropping it at the end. Here a block walks one row's chunks in
// a loop, starts from s0 and writes the final state, which decode and the
// serving paths need.
//
// What bounds it on an H100: bytes, in principle. The function reads r, k,
// v, w once and writes y once (5 * BH * S * hd elements) against about
// 4 * hd fp32 operations per element, below the card's ratio of fp32
// operations to bytes. What a design has to beat is the chain: only the
// two state terms, (r e^lprev) S and the update of S, depend on the
// previous chunk, but a row's chunks must pass through them one after
// another. Everything else is chunk-local. So a block of 16 warps in four
// roles passes each chunk through a ring of DEPTH stages in shared memory:
//
// * Loads: chunk c's [Q, hd] tiles of r, k, v, w come in by four
//   cp.async.bulk copies completed on the stage's mbarrier. Thread 0
//   issues the first DEPTH; after that the IN side of the producers
//   issues chunk c + DEPTH as soon as it is done with chunk c's raw tiles.
// * Decay team (4 warps): the cumulative decay l, e^{l_Q}, r e^lprev and
//   k e^{l_Q - l} (split into TF32 high and low parts for the tensor
//   cores), k e^-l and r u k, one channel a thread, every load before the
//   first store so the expf chains of its items overlap. It starts chunk
//   c + DEPTH once the consumers are done with chunk c.
// * A and IN team (8 warps), a chunk behind: the 136 entries of the lower
//   triangle of A (the bonus on the diagonal), one a thread in fp32, and v
//   split for the consumers; then the intra-chunk output tril(A) v on the
//   tensor cores, a column group of 8 a warp.
// * Consumers (hd / G / 16 warps): only the two state terms. They run on
//   the tensor cores in 3xTF32: each fp32 operand is split into a rounded
//   TF32 high part and the rest, and lo hi + hi lo + hi hi are accumulated
//   in fp32 (mma.sync m16n8k8), about fp32's accuracy where one TF32 pass
//   keeps three digits. A consumer warp owns 16 columns j of S and of y
//   and holds S^T [16 j, hd] as mma accumulators in registers: the update
//   S^T += v^T (k e^{l_Q - l}) accumulates into them after the decay, and
//   they serve as the A operand of y^T = S^T (r e^lprev)^T as they are,
//   taking each 8-channel group's k-slots in the order 0 2 4 6 1 3 5 7.
//   The mma of one term go to different accumulators in turn.
//
// Stages change hands on mbarriers (loaded, decayed, prepared, consumed);
// each team orders its own steps with a named barrier; nothing is
// block-wide after the start. A row's value columns split across G
// blocks: column j of y and of S needs only column j of v and of S0, so G
// blocks of hd / G columns run a row side by side, each recomputing the
// chunk-local terms, which it must have whole. Every column's arithmetic
// is the same for any G (a launch argument, not a template one), so the
// result depends on neither G nor BH. The host's plan (kernels/wkv6.py,
// launch_plan) picks G from BH, hd and the SM count. The ring is DEPTH = 3
// stages deep for every plan: 227 KB holds three of fp32 hd 64's widest
// block, and on the card a deeper or shallower ring moves a chunk's time by
// under 1% (PERF.md). With 416 to 512 threads at up to 128 registers a
// block takes most of an SM's registers, so one block runs on an SM
// whatever its shared memory.
//
// On the card (PERF.md) a chunk of rwkv6-3b's prefill row takes about
// 3,400 cycles whatever the ring's depth, and each role waits for the
// others a quarter to a half of that: the chunk time is set by the roles'
// shared use of the SM (registers cap every thread at 128; shared-memory
// traffic), not by one serial chain. No atomics: deterministic, so
// swapped and unswapped runs agree bitwise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int CHUNK = 16;                     // Q at most (RWKV_CHUNK)
constexpr int NA = 128;                       // decay team's threads
constexpr int NB = 256;                       // A and IN team's threads
constexpr int NP = NA + NB;                   // producer threads
constexpr int COLS = 16;                      // columns of a consumer warp
constexpr int AS = 20;                        // row stride of A (float4 rows)
constexpr int DEPTH = 3;                      // the ring's stages
constexpr int SMEM_MAX = 232448;              // a block's dynamic limit

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

// one contiguous run of global memory into shared memory, completed on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero),
// lo = x - hi exactly; the tensor cores read lo's top 19 bits (3xTF32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small products first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// acc[e] += a[e] b[e], four partial sums of a dot product
__device__ __forceinline__ void dot4(float (&acc)[4], float4 a, float4 b) {
  acc[0] = fmaf(a.x, b.x, acc[0]);
  acc[1] = fmaf(a.y, b.y, acc[1]);
  acc[2] = fmaf(a.z, b.z, acc[2]);
  acc[3] = fmaf(a.w, b.w, acc[3]);
}

// Byte offsets in the dynamic shared memory. A stage holds the raw tiles
// r, k, v, w ([16, hd] in the input type); what the consumers read: RDH /
// RDL, r e^lprev split into TF32 high and low parts, and KTH / KTL,
// k e^{l_Q - l} split ([16, hd + 8] fp32: the mma fragments' rows fall in
// distinct banks), DEC = e^{l_Q} [hd], IN = tril(A) v for the block's C
// columns ([16, C + 4]) and VH / VL, v split, in the order of the
// consumers' mma fragments ([C / 16 warps][2][4][32 lanes]); what the decay
// team hands the other producers: RDF = r e^lprev and KI = k e^-l ([16,
// hd + 4]), RK = r u k ([16, hd]). After the DEPTH stages: A ([16, 20],
// zero above the diagonal), U = u [hd], then 4 DEPTH mbarriers. Everything but the
// stage's length, the offsets that follow IN and the scratch's start is
// known at compile time.
template <int HD, int ELT>
struct Lay {
  static constexpr int RAW = CHUNK * HD * ELT;
  static constexpr int RS = HD + 8;
  static constexpr int PART = CHUNK * RS * 4;
  static constexpr int RDH = 4 * RAW;
  static constexpr int RDL = RDH + PART;
  static constexpr int KTH = RDL + PART;
  static constexpr int KTL = KTH + PART;
  static constexpr int DEC = KTL + PART;
  static constexpr int RDF = DEC + HD * 4;
  static constexpr int KI = RDF + CHUNK * (HD + 4) * 4;
  static constexpr int RK = KI + CHUNK * (HD + 4) * 4;
  static constexpr int IN = RK + CHUNK * HD * 4;
  static constexpr int A = 0;                    // from the scratch's start
  static constexpr int U = A + CHUNK * AS * 4;
  static constexpr int BARS = U + HD * 4;
  __host__ __device__ static constexpr int vh(int C) {
    return IN + CHUNK * (C + 4) * 4;
  }
  __host__ __device__ static constexpr int vl(int C) { return vh(C) + 64 * C; }
  __host__ __device__ static constexpr int stage(int C) {
    return vl(C) + 64 * C;
  }
  __host__ __device__ static constexpr int total(int C) {
    return DEPTH * stage(C) + BARS + 4 * DEPTH * 8;
  }
};

// Step 1 for the decay team's group TG (hd threads, one channel each): of
// the chunk's 32 (side, step) items, the group takes its 32 / (NA / hd) in
// a straight line, every load before the first store so that the items
// overlap. An r-side item writes r e^lprev (split, and whole for step 2)
// and r u k; a k-side item k e^-l and k e^{l_Q - l} = k e^{l_Q} e^-l (both
// factors lie in [e^-80, e^80], so neither the product nor a factor leaves
// fp32's range). Rows at or past Q read r = k = 0 and are written as
// zeros.
template <typename T, int HD, int TG>
__device__ __forceinline__ void decay_items(
    const T* Rr, const T* Kr, const float (&l)[CHUNK],
    const float (&lw)[CHUNK], float lq, float uc, int ch, int Q, float* RDH,
    float* RDL, float* KTH, float* KTL, float* RDF, float* KI, float* RK) {
  using L = Lay<HD, sizeof(T)>;
  constexpr int PER = 2 * CHUNK / (NA / HD);
  constexpr int E0 = TG * PER;
  constexpr bool RSIDE = E0 < CHUNK;
  float x[PER], kr[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int t = (E0 + e) % CHUNK;
    x[e] = t < Q ? to_f<T>((RSIDE ? Rr : Kr)[t * HD + ch]) : 0.f;
    kr[e] = RSIDE && t < Q ? to_f<T>(Kr[t * HD + ch]) : 0.f;
  }
  const float elq = RSIDE ? 0.f : expf(lq);
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int t = (E0 + e) % CHUNK;
    uint32_t hi, lo;
    if (RSIDE) {
      const float rd = x[e] * expf(l[t] - lw[t]);
      split(rd, hi, lo);
      RDH[t * L::RS + ch] = __uint_as_float(hi);
      RDL[t * L::RS + ch] = __uint_as_float(lo);
      RDF[t * (HD + 4) + ch] = rd;
      RK[t * HD + ch] = x[e] * (uc * kr[e]);
    } else {
      const float ek = expf(-l[t]);
      KI[t * (HD + 4) + ch] = x[e] * ek;
      split(x[e] * (elq * ek), hi, lo);
      KTH[t * L::RS + ch] = __uint_as_float(hi);
      KTL[t * L::RS + ch] = __uint_as_float(lo);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NP + 2 * HD, 1)
wkv6_ring(const T* __restrict__ r, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ w,
          const T* __restrict__ u, const float* __restrict__ s0,
          T* __restrict__ y, float* __restrict__ s_out, int S, int Q,
          int G) {
  extern __shared__ __align__(128) uint8_t smem[];
  using L = Lay<HD, sizeof(T)>;
  const int C = HD / G;                       // this block's columns
  const int stage = L::stage(C);
  const int row = blockIdx.x / G;
  const int col0 = (blockIdx.x % G) * C;
  const int nc = S / Q;
  const size_t base = (size_t)row * S * HD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;      // mma fragment coordinates

  uint8_t* scratch = smem + DEPTH * stage;
  float* A = reinterpret_cast<float*>(scratch + L::A);
  float* U = reinterpret_cast<float*>(scratch + L::U);
  uint64_t* loaded = reinterpret_cast<uint64_t*>(scratch + L::BARS);
  uint64_t* decayed = loaded + DEPTH;             // step 1 done
  uint64_t* prepared = decayed + DEPTH;           // steps 2 and 3 done
  uint64_t* consumed = prepared + DEPTH;          // the consumers are done

  // chunk c's r, k, v, w tiles into stage c % DEPTH, completed on its
  // mbarrier
  const uint32_t tile = Q * HD * sizeof(T);
  auto load = [&](int c) {
    const int s = c % DEPTH;
    uint8_t* st = smem + s * stage;
    const size_t off = base + (size_t)c * Q * HD;
    mbar_expect_tx(&loaded[s], 4 * tile);
    bulk_load(st, r + off, tile, &loaded[s]);
    bulk_load(st + L::RAW, k + off, tile, &loaded[s]);
    bulk_load(st + 2 * L::RAW, v + off, tile, &loaded[s]);
    bulk_load(st + 3 * L::RAW, w + off, tile, &loaded[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&decayed[s], 1);
      mbar_init(&prepared[s], 1);
      mbar_init(&consumed[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < DEPTH && c < nc; ++c) load(c);
  }
  if (tid < HD) U[tid] = to_f<T>(u[(size_t)row * HD + tid]);
  __syncthreads();

  if (warp < NA / 32) {
    // ---- decay team: step 1, once the chunk is loaded and the consumers
    //      are done with the stage's last chunk
    const int ch = tid % HD;
    const int tg = tid / HD;
    const float uc = U[ch];
    for (int c = 0; c < nc; ++c) {
      const int s = c % DEPTH;
      mbar_wait(&loaded[s], (c / DEPTH) & 1);
      mbar_wait(&consumed[s], ((c / DEPTH) & 1) ^ 1);
      uint8_t* st = smem + s * stage;
      const T* Wr = reinterpret_cast<const T*>(st + 3 * L::RAW);
      float lw[CHUNK], l[CHUNK];
      float lq = 0.f;
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        lw[t] = t < Q ? to_f<T>(Wr[t * HD + ch]) : 0.f;
        lq += lw[t];
        l[t] = lq;
      }
#define WKV_ITEMS(n)                                                       \
  decay_items<T, HD, n % (NA / HD)>(                                       \
      reinterpret_cast<const T*>(st),                                      \
      reinterpret_cast<const T*>(st + L::RAW), l, lw, lq, uc, ch, Q,       \
      reinterpret_cast<float*>(st + L::RDH),                               \
      reinterpret_cast<float*>(st + L::RDL),                               \
      reinterpret_cast<float*>(st + L::KTH),                               \
      reinterpret_cast<float*>(st + L::KTL),                               \
      reinterpret_cast<float*>(st + L::RDF),                               \
      reinterpret_cast<float*>(st + L::KI),                                \
      reinterpret_cast<float*>(st + L::RK))
      // one copy of each group's straight line (NA / HD groups)
      if (NA / HD == 2) {
        if (tg == 0) {
          WKV_ITEMS(0);
        } else {
          WKV_ITEMS(1);
        }
      } else {
        switch (tg) {
          case 0: WKV_ITEMS(0); break;
          case 1: WKV_ITEMS(1); break;
          case 2: WKV_ITEMS(2); break;
          default: WKV_ITEMS(3);
        }
      }
#undef WKV_ITEMS
      if (tg == 0) reinterpret_cast<float*>(st + L::DEC)[ch] = expf(lq);
      named_sync(1, NA);
      if (tid == 0) mbar_arrive(&decayed[s]);
    }
    return;
  }

  if (warp < NP / 32) {
    // ---- A and IN team: steps 2 and 3 of the chunk the decay team did
    //      before, while that team works on the next one; then the stage's
    //      raw tiles are free, and the chunk DEPTH ahead is loaded into
    //      them
    const int p = tid - NA;
    const int pw = p >> 5;
    // step 2's entry: the p-th of the lower triangle, row by row
    const int at = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
    const int ai = p - at * (at + 1) / 2;
    for (int e = p; e < CHUNK * AS; e += NB) A[e] = 0.f;   // upper: zeros
    named_sync(2, NB);
    for (int c = 0; c < nc; ++c) {
      const int s = c % DEPTH;
      mbar_wait(&loaded[s], (c / DEPTH) & 1);
      mbar_wait(&decayed[s], (c / DEPTH) & 1);
      uint8_t* st = smem + s * stage;
      const T* Vr = reinterpret_cast<const T*>(st + 2 * L::RAW);
      const float* RDF = reinterpret_cast<const float*>(st + L::RDF);
      const float* KI = reinterpret_cast<const float*>(st + L::KI);
      const float* RK = reinterpret_cast<const float*>(st + L::RK);
      float* IN = reinterpret_cast<float*>(st + L::IN);
      float* VH = reinterpret_cast<float*>(st + L::vh(C));
      float* VL = reinterpret_cast<float*>(st + L::vl(C));

      // 2. A[t, i] = RDF_t . KI_i for i < t and A[t, t] = sum_c RK[t, c]
      //    (times one: the same sum), one of the 136 entries a thread
      if (p < CHUNK * (CHUNK + 1) / 2 && at < Q) {
        const bool bonus = ai == at;
        const float* X = bonus ? RK + at * HD : RDF + at * (HD + 4);
        const float* Z = KI + ai * (HD + 4);
        const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int c4 = 0; c4 < HD; c4 += 4) {
          const float4 x = *reinterpret_cast<const float4*>(X + c4);
          const float4 z =
              bonus ? one : *reinterpret_cast<const float4*>(Z + c4);
          dot4(acc, x, z);
        }
        A[at * AS + ai] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      // v split for the consumers, in their fragments' order
      for (int x = p; x < 16 * C; x += NB) {
        const int ln = x & 31, e = (x >> 5) & 3, kt = (x >> 7) & 1;
        const int t = 8 * kt + (ln & 3) + (e & 2) * 2;
        const int jl = COLS * (x >> 8) + (ln >> 2) + (e & 1) * 8;
        uint32_t hi, lo;
        split(t < Q ? to_f<T>(Vr[t * HD + col0 + jl]) : 0.f, hi, lo);
        VH[x] = __uint_as_float(hi);
        VL[x] = __uint_as_float(lo);
      }
      named_sync(2, NB);

      // 3. IN [16 t, C] = A v[:, col0 + [0, C)] in 3xTF32 (A is zero above
      //    the diagonal): producer warp pw takes column group pw (8
      //    columns). Column j's sums are the same whatever C is
      if (8 * pw < C) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const int j = col0 + 8 * pw + g;
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = g + (e & 1) * 8, i = 8 * kt + q + (e & 2) * 2;
            split(A[t * AS + i], ah[e], al[e]);
          }
          const int i = 8 * kt + q;
          uint32_t bh0, bl0, bh1, bl1;
          split(i < Q ? to_f<T>(Vr[i * HD + j]) : 0.f, bh0, bl0);
          split(i + 4 < Q ? to_f<T>(Vr[(i + 4) * HD + j]) : 0.f, bh1, bl1);
          mma3(d, ah, al, bh0, bh1, bl0, bl1);
        }
        const int jl = 8 * pw + 2 * q;
        *reinterpret_cast<float2*>(IN + g * (C + 4) + jl) =
            make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(IN + (g + 8) * (C + 4) + jl) =
            make_float2(d[2], d[3]);
      }
      named_sync(2, NB);
      if (p == 0) {
        mbar_arrive(&prepared[s]);
        if (c + DEPTH < nc) load(c + DEPTH);
      }
    }
    return;
  }

  // ---- consumers: the state terms on the tensor cores. Warp cw owns
  //      columns col0 + 16 cw + [0, 16): S^T [16 j, HD ch] as NT mma
  //      accumulators, lane (g, q) holding rows g, g + 8 and, in channel
  //      group n, channels 8 n + 2 q, 8 n + 2 q + 1
  constexpr int NT = HD / 8;
  constexpr int GS = 4;                       // channel groups a pass
  const int cw = warp - NP / 32;
  const int jl0 = COLS * cw + g;              // this lane's columns jl0, +8
  const int j0 = col0 + jl0;
  float Sc[NT][4];
  const float* s0_row = s0 ? s0 + (size_t)row * HD * HD : nullptr;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c0 = 8 * n + 2 * q;
    Sc[n][0] = s0_row ? s0_row[c0 * HD + j0] : 0.f;
    Sc[n][1] = s0_row ? s0_row[(c0 + 1) * HD + j0] : 0.f;
    Sc[n][2] = s0_row ? s0_row[c0 * HD + j0 + 8] : 0.f;
    Sc[n][3] = s0_row ? s0_row[(c0 + 1) * HD + j0 + 8] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int s = c % DEPTH;
    mbar_wait(&prepared[s], (c / DEPTH) & 1);
    const uint8_t* st = smem + s * stage;
    const uint32_t* RDH = reinterpret_cast<const uint32_t*>(st + L::RDH);
    const uint32_t* RDL = reinterpret_cast<const uint32_t*>(st + L::RDL);
    const uint32_t* KTH = reinterpret_cast<const uint32_t*>(st + L::KTH);
    const uint32_t* KTL = reinterpret_cast<const uint32_t*>(st + L::KTL);
    const float* DEC = reinterpret_cast<const float*>(st + L::DEC);
    const float* IN = reinterpret_cast<const float*>(st + L::IN);
    const uint32_t* VH = reinterpret_cast<const uint32_t*>(st + L::vh(C));
    const uint32_t* VL = reinterpret_cast<const uint32_t*>(st + L::vl(C));
    // a zero initial state contributes nothing to the first chunk
    const bool fresh = c == 0 && s0_row == nullptr;
    const size_t off = base + (size_t)c * Q * HD;

    // Both state terms read the old S^T, GS channel groups n at a time:
    // y^T [16 j, 16 t] += S^T (r e^lprev)^T (two step tiles m, four
    // accumulators Y[m][n % 2]), then those groups of S^T <- e^{l_Q} S^T +
    // v^T (k e^{l_Q - l}) (A = v^T [16 j, 16 t] in two step groups kt, B =
    // KT [16 t, 8 ch]). The mma of one 3xTF32 term go to different
    // accumulators in turn, so that few mma wait on the one before them; v
    // is loaded where the update needs it, which keeps every thread within
    // its 128 registers
    float Y[2][2][4] = {};
#pragma unroll
    for (int h = 0; h < NT / GS; ++h) {
      if (!fresh) {
        uint32_t ah[GS][4], al[GS][4];
        uint2 bh[GS][2], bl[GS][2];
#pragma unroll
        for (int p4 = 0; p4 < GS; ++p4) {
          const int n = GS * h + p4;
          split(Sc[n][0], ah[p4][0], al[p4][0]);
          split(Sc[n][2], ah[p4][1], al[p4][1]);
          split(Sc[n][1], ah[p4][2], al[p4][2]);
          split(Sc[n][3], ah[p4][3], al[p4][3]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const int o = (8 * m + g) * L::RS + 8 * n + 2 * q;
            bh[p4][m] = *reinterpret_cast<const uint2*>(RDH + o);
            bl[p4][m] = *reinterpret_cast<const uint2*>(RDL + o);
          }
        }
#pragma unroll
        for (int p4 = 0; p4 < GS; ++p4) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma(Y[m][p4 % 2], al[p4], bh[p4][m].x, bh[p4][m].y);
          }
        }
#pragma unroll
        for (int p4 = 0; p4 < GS; ++p4) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma(Y[m][p4 % 2], ah[p4], bl[p4][m].x, bl[p4][m].y);
          }
        }
#pragma unroll
        for (int p4 = 0; p4 < GS; ++p4) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma(Y[m][p4 % 2], ah[p4], bh[p4][m].x, bh[p4][m].y);
          }
        }
      }
      uint32_t vh[2][4], vl[2][4];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          vh[kt][e] = VH[((2 * cw + kt) * 4 + e) * 32 + lane];
          vl[kt][e] = VL[((2 * cw + kt) * 4 + e) * 32 + lane];
        }
      }
      uint32_t kh[GS][2][2], kl[GS][2][2];
#pragma unroll
      for (int p4 = 0; p4 < GS; ++p4) {
        const int n = GS * h + p4;
        if (fresh) {
#pragma unroll
          for (int e = 0; e < 4; ++e) Sc[n][e] = 0.f;
        } else {
          const float2 d =
              *reinterpret_cast<const float2*>(DEC + 8 * n + 2 * q);
          Sc[n][0] *= d.x;
          Sc[n][1] *= d.y;
          Sc[n][2] *= d.x;
          Sc[n][3] *= d.y;
        }
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          const int o = (8 * kt + q) * L::RS + 8 * n + g;
          kh[p4][kt][0] = KTH[o];
          kh[p4][kt][1] = KTH[o + 4 * L::RS];
          kl[p4][kt][0] = KTL[o];
          kl[p4][kt][1] = KTL[o + 4 * L::RS];
        }
      }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
        for (int p4 = 0; p4 < GS; ++p4) {
          mma(Sc[GS * h + p4], vl[kt], kh[p4][kt][0], kh[p4][kt][1]);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
        for (int p4 = 0; p4 < GS; ++p4) {
          mma(Sc[GS * h + p4], vh[kt], kl[p4][kt][0], kl[p4][kt][1]);
        }
      }
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
        for (int p4 = 0; p4 < GS; ++p4) {
          mma(Sc[GS * h + p4], vh[kt], kh[p4][kt][0], kh[p4][kt][1]);
        }
      }
    }

    // y = IN + y^T's transpose: every value first, then the stores (rows
    // at or past Q are not stored)
    float out[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * m + 2 * q + (e & 1);
        const float in = IN[t * (C + 4) + jl0 + (e & 2) * 4];
        out[m][e] = fresh ? in : in + (Y[m][0][e] + Y[m][1][e]);
      }
    }
    T* yq = y + off + (size_t)(2 * q) * HD + j0;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dt = 8 * m + (e & 1);
        if (2 * q + dt < Q) yq[dt * HD + (e & 2) * 4] = from_f<T>(out[m][e]);
      }
    }
    // the stage's hand-over terms are free once every consumer warp is done
    named_sync(3, 2 * C);
    if (cw == 0 && lane == 0) mbar_arrive(&consumed[s]);
  }

  float* so = s_out + (size_t)row * HD * HD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c0 = 8 * n + 2 * q;
    so[c0 * HD + j0] = Sc[n][0];
    so[(c0 + 1) * HD + j0] = Sc[n][1];
    so[c0 * HD + j0 + 8] = Sc[n][2];
    so[(c0 + 1) * HD + j0 + 8] = Sc[n][3];
  }
}

bool plan_ok(int hd, int groups) {
  return (groups == 1 || groups == 2 || groups == 4) &&
         hd % (COLS * groups) == 0;
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int BH, int S,
           int Q, int G, cudaStream_t stream) {
  // a block's columns are at most HD, and its shared memory grows with them
  static_assert(Lay<HD, sizeof(T)>::total(HD) <= SMEM_MAX,
                "the ring's stages exceed a block's shared memory");
  const int C = HD / G;
  const int bytes = Lay<HD, sizeof(T)>::total(C);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_ring<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_ring<T, HD><<<BH * G, NP + 2 * C, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), S, Q, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* s_out, int BH,
              int S, int Q, int hd, int G, cudaStream_t stream) {
  if (hd == 64) {
    return launch<T, 64>(r, k, v, w, u, s0, y, s_out, BH, S, Q, G, stream);
  }
  return launch<T, 32>(r, k, v, w, u, s0, y, s_out, BH, S, Q, G, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (r, k, v, w_log, u and y); hd: 32 or 64;
// S % min(16, S) == 0; s0 may be null (zeros); groups: G blocks a row, each
// hd / G columns (16 | hd / G). Every pointer 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w_log, const void* u, const void* s0,
                          void* y, void* s_out, int BH, int S, int hd,
                          int dtype, int groups, void* stream) {
  const int Q = S < CHUNK ? S : CHUNK;
  if (BH <= 0 || S <= 0 || S % Q != 0 || (hd != 32 && hd != 64) ||
      dtype < 0 || dtype > 1 || !plan_ok(hd, groups)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(r, k, v, w_log, u, s0, y, s_out, BH, S,
                                    Q, hd, groups, st);
  }
  return launch_hd<float>(r, k, v, w_log, u, s0, y, s_out, BH, S, Q, hd,
                          groups, st);
}
