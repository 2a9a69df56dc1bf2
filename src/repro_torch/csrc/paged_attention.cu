// paged_attention: single-token GQA decode attention through a page table,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention, body _kernel), which the paged continuous-batching
// decode runs once per attention layer per batched step.
//
//   q [B, H, hd]; k_pages, v_pages [P, T, KV, hd] (q's dtype); page_table
//   [B, NP] int32 padded with the zero page 0; seq_lens [B] int32 ->
//   out [B, H, hd] in q's dtype. The query sits at position seq_len - 1;
//   token tok of a sequence lies in page page_table[b, tok / T], slot
//   tok % T.
//
// Semantics kept from the TPU kernel: scores are q.k * scale, then the
// softcap (cap * tanh(s / cap)), then the mask (tok < seq_len and, with a
// window, q_pos - tok < window); masked scores are the finite NEG_INF; the
// online softmax (m, l, acc) runs in fp32; l is clamped at 1e-30. Only the
// live, in-window tokens [lo, hi) are read, lo = seq_len - window (0
// without a window), hi = seq_len: a page past the sequence or wholly out
// of the window is never read, so the padding page 0 never reaches the
// softmax.
//
// What bounds it on an H100: bytes. Each live, in-window K/V row is read
// from HBM once per KV head (2 * hd * itemsize bytes; a KV head's further
// groups of query heads read it again, mostly from L2), against 4 * G * hd
// flops per
// token: far below the card's ratio of flops to bytes. So the card must
// have enough rows in flight, and a long sequence has to be spread over
// many SMs (flash-decoding):
//
// * Splits. [lo, hi) is cut into splits of L tokens from lo (the last
//   one shorter); L is a constant of (hd, dtype, T) that the caller passes
//   (kernels/paged_attention.py::split_len: a multiple of T and of the
//   chunk, about 64 tokens at hd 128 and 128 at hd 256, so gemma2-9b's
//   4,201-token context makes 33 splits a KV head). The boundaries depend
//   only on the sequence's own seq_len, the window and L, never on B or
//   the other sequences, so a sequence's output has the same bits alone or
//   in any batch. The grid is
//   (the most splits the page table's width NP allows, KV, B); a block
//   past its sequence's split count exits at once.
// * One split: the block writes the output itself, so short contexts pay
//   no second pass. More: each block writes its split's (m, l, acc[G, hd])
//   in fp32 to scratch, and a second kernel adds the splits of each
//   sequence in split order (weights exp(m_s - max m)); no atomics.
// * Inside a split, one block of 128 threads per (split, KV head, group
//   of up to 8 of its query heads, sequence) reads each K/V row once for
//   the group's heads. A KV head with G > 8 query heads (granite-20b's MQA:
//   G 48) has ceil(G / 8) groups, each a block that reads the split's rows
//   again (mostly from L2). The split's
//   page ids are read into shared memory first, so no row load waits on
//   the page table. Rows arrive by 16-byte cp.async into a ring of 3
//   stages of CHUNK tokens (16-64; at most 16 KB of K per stage) and stay
//   in q's dtype in shared memory, widened at use. A thread takes one
//   token's dot products for up to G heads (its K row read once, rows
//   padded so a quarter warp's 16-byte reads hit every bank once, four
//   partial sums a head), or, where there are fewer heads than thread
//   groups, one head over a part of hd, so no thread idles; the softmax
//   lanes add the parts, computing each score's tanh and exp once; then
//   a thread takes a pair of output columns for its heads. Three barriers
//   a chunk.
// * Head dims. The kernel is compiled at row widths HDP of 64, 128 and 256;
//   any hd that is a multiple of 8 up to 256 runs at the smallest HDP >= hd.
//   Rows keep their width hd in the pools and in q and out (h2o-danube's
//   120: 240-byte bf16 rows, still 16-byte vectors); a row lands in an
//   HDP-wide shared row whose columns past hd are zero-filled (cp.async of
//   source size 0), q's too, so the dot products and the output run at HDP
//   and only hd columns are written. The scale is the caller's (hd's).
// The heads of a group are bucketed to a compile-time GB in {1, 2, 4, 8}.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "sm90_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;          // query heads a block (a group's)
constexpr int STAGES = 3;
constexpr int MAX_PAGES = 512;    // page ids a split reads, kept in shared
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

// HD is the shared row width HDP (an hd up to it runs zero-padded)
template <typename DT, int HD> struct Paged {
  static constexpr int ES = (int)sizeof(DT);
  // tokens a stage (kernels/paged_attention.py::chunk_tokens)
  static constexpr int CHUNK = 16384 / (HD * ES) < 64 ? 16384 / (HD * ES) : 64;
  static constexpr int VEC = 16 / ES;             // elements per 16 bytes
  static constexpr int ROW_V = HD / VEC;          // 16-byte vectors a row
  static constexpr int LD = HD + VEC;             // shared row stride
  static constexpr int TILE = CHUNK * LD;         // elements of K (or V)
  static constexpr int NV = CHUNK * ROW_V / THREADS;  // vectors a thread
  static constexpr int GSTEP = THREADS / CHUNK;   // head step of a score
  static constexpr int DP = HD / 2;               // column pairs
  static constexpr int GQ = DP >= THREADS ? 1 : THREADS / DP;  // head step
  static constexpr int PPT = DP >= THREADS ? DP / THREADS : 1; // pairs/thread
  static constexpr int SMEM_BYTES = STAGES * 2 * TILE * ES;
  static_assert(CHUNK * ROW_V % THREADS == 0, "a chunk splits evenly");
  static_assert(CHUNK <= 64 && THREADS % CHUNK == 0, "chunk shape");
};

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

// 16 bytes of shared memory widened to fp32
__device__ __forceinline__ void widen16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    memcpy(&h, &w[i], 4);
    const float2 x = __bfloat1622float2(h);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
// a pair of neighbouring elements widened to fp32
__device__ __forceinline__ float2 widen2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A sequence's live, in-window tokens [lo, hi) and its split count, as
// kernels/paged_attention.py::split_bounds computes them on the host: a
// change to one must be made to the other (split_plan below lets the
// card's tests hold them together).
__device__ __forceinline__ int live_range(int seq_len, int window, int cap,
                                          int L, int& lo, int& hi) {
  hi = min(seq_len, cap);
  lo = window > 0 ? max(0, seq_len - window) : 0;
  const int live = max(0, hi - lo);
  return (live + L - 1) / L;
}

struct PagedArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* page_table;
  const int32_t* seq_lens;
  void* out;
  float* part;          // [B, KV, SMAX, G, hd] acc, then [B, KV, SMAX, G, 2]
  int H, KV, T, NP, L, smax;
  int hd;               // the rows' width in q, the pools and out
  int gsz, ngroups;     // query heads a group (<= MAX_G), groups a KV head
  float scale;
  int window;
  float softcap;
};

template <typename DT, int HD, int GB>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const PagedArgs a) {
  using P = Paged<DT, HD>;
  // a score thread takes GPT heads, or (fewer heads than thread groups)
  // one head over 1 / PARTS of hd, its partial sums added in order later
  constexpr int PARTS = GB < P::GSTEP ? P::GSTEP / GB : 1;
  constexpr int GPT = PARTS > 1 ? 1 : GB / P::GSTEP;
  constexpr int GPV = (GB + P::GQ - 1) / P::GQ;         // heads an acc thread
  static_assert(P::ROW_V % PARTS == 0, "hd splits evenly");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DT* ring = reinterpret_cast<DT*>(smem_raw);           // K0 V0 K1 V1 ...
  __shared__ __align__(16) float q_s[GB][HD];
  __shared__ float s_s[PARTS][GB][64];    // dot products; then p in [0]
  __shared__ float m_s[GB], l_s[GB], corr_s[GB];
  __shared__ int pg_s[MAX_PAGES];

  const int sp = blockIdx.x;
  const int kv = blockIdx.y / a.ngroups;
  const int grp = blockIdx.y % a.ngroups;
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int g0 = grp * a.gsz;               // the group's first head in kv's
  const int Gl = min(a.gsz, G - g0);        // the group's heads (<= GB)
  const int hd = a.hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int seq_len = a.seq_lens[b];
  int lo, hi;
  const int nsplit = live_range(seq_len, a.window, a.NP * a.T, a.L, lo, hi);
  if (sp >= max(nsplit, 1)) return;
  const int s0 = lo + sp * a.L;
  const int s1 = min(s0 + a.L, hi);
  const int nch = s1 > s0 ? (s1 - s0 + P::CHUNK - 1) / P::CHUNK : 0;

  const DT* q = static_cast<const DT*>(a.q);
#pragma unroll      // every load in flight at once
  for (int i = 0; i < (GB * HD + THREADS - 1) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    if (e >= GB * HD) break;
    const int g = e / HD, d = e % HD;    // rows past Gl, columns past hd
    q_s[g][d] = g < Gl && d < hd            // stay zero
                    ? to_f<DT>(q[((int64_t)b * a.H + kv * G + g0 + g) * hd + d])
                    : 0.f;
  }
  if (tid < GB) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // the split's page ids, read once: no load waits on the page table
  const int p0 = s0 / a.T;
  const int32_t* row = a.page_table + (int64_t)b * a.NP;
  for (int e = tid; s1 > s0 && e <= (s1 - 1) / a.T - p0; e += THREADS) {
    pg_s[e] = row[p0 + e];
  }
  __syncthreads();

  const DT* kp = static_cast<const DT*>(a.k);
  const DT* vp = static_cast<const DT*>(a.v);
  // cp.async of chunk c's K and V rows into stage c % STAGES (zeros past s1
  // and past column hd)
  auto load = [&](int c) {
    DT* ks = ring + (c % STAGES) * 2 * P::TILE;
    DT* vs = ks + P::TILE;
#pragma unroll
    for (int i = 0; i < P::NV; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / P::ROW_V, c16 = (e % P::ROW_V) * P::VEC;
      const int tok = s0 + c * P::CHUNK + r;
      const bool ok = tok < s1 && c16 < hd;
      int64_t off = 0;
      if (ok) {
        const int pg = tok / a.T;
        const int64_t slot = (int64_t)pg_s[pg - p0] * a.T + (tok - pg * a.T);
        off = (slot * a.KV + kv) * hd + c16;
      }
      cp_async16(ks + r * P::LD + c16, kp + off, ok);
      cp_async16(vs + r * P::LD + c16, vp + off, ok);
    }
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nch) load(c);
    cp_async_commit();
  }

  float acc[GPV][P::PPT][2];
#pragma unroll
  for (int k = 0; k < GPV; ++k)
#pragma unroll
    for (int p = 0; p < P::PPT; ++p) acc[k][p][0] = acc[k][p][1] = 0.f;
  const int t = tid % P::CHUNK, gh = tid / P::CHUNK;     // score thread
  const int dp = tid % (P::DP < THREADS ? P::DP : THREADS);
  const int gq = P::DP < THREADS ? tid / P::DP : 0;     // acc thread

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // chunk c is in; chunk c - 1 is done with
    if (c + STAGES - 1 < nch) load(c + STAGES - 1);
    cp_async_commit();
    const DT* ks = ring + (c % STAGES) * 2 * P::TILE;
    const DT* vs = ks + P::TILE;
    const int c0 = s0 + c * P::CHUNK;
    const int ch = min(P::CHUNK, s1 - c0);

    // dot products: token t for heads gh, gh + GSTEP, ... (or head
    // gh % GB over part gh / GB of hd); four partial sums a head (vector
    // element x % 4) so the fma chains run side by side
    {
      const int part = PARTS > 1 ? gh / GB : 0;
      const int h0 = PARTS > 1 ? gh % GB : gh;
      float dot[GPT][4];
#pragma unroll
      for (int k = 0; k < GPT; ++k)
#pragma unroll
        for (int x = 0; x < 4; ++x) dot[k][x] = 0.f;
#pragma unroll 4
      for (int i = 0; i < P::ROW_V / PARTS; ++i) {
        const int vi = part * (P::ROW_V / PARTS) + i;
        float kf[P::VEC];
        widen16(ks + t * P::LD + vi * P::VEC, kf);
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
          const int g = h0 + P::GSTEP * k;
          if (g < GB) {
#pragma unroll
            for (int x = 0; x < P::VEC; ++x) {
              dot[k][x & 3] =
                  fmaf(q_s[g][vi * P::VEC + x], kf[x], dot[k][x & 3]);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < GPT; ++k) {
        const int g = h0 + P::GSTEP * k;
        if (g < Gl) {
          s_s[part][g][t] = (dot[k][0] + dot[k][1]) + (dot[k][2] + dot[k][3]);
        }
      }
    }
    __syncthreads();
    // online softmax: one warp per query head, two tokens a lane; a
    // score's parts added in order, then scale, softcap, mask
    auto score = [&](int g, int tt) {
      float x = s_s[0][g][tt];
#pragma unroll
      for (int pp = 1; pp < PARTS; ++pp) x += s_s[pp][g][tt];
      x *= a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      return tt < ch ? x : NEG_INF;
    };
    for (int g = warp; g < Gl; g += WARPS) {
      const float x0 = lane < P::CHUNK ? score(g, lane) : NEG_INF;
      const float x1 = lane + 32 < P::CHUNK ? score(g, lane + 32) : NEG_INF;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = lane < ch ? expf(x0 - m_new) : 0.f;
      const float p1 = lane + 32 < ch ? expf(x1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      if (lane < P::CHUNK) s_s[0][g][lane] = p0;
      if (lane + 32 < P::CHUNK) s_s[0][g][lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();
    // acc[g, d pair] = acc * corr + sum_t p[g, t] * v[t, d pair]
#pragma unroll
    for (int k = 0; k < GPV; ++k) {
      const int g = gq + P::GQ * k;
      if (g < Gl) {
        const float corr = corr_s[g];
#pragma unroll
        for (int p = 0; p < P::PPT; ++p) {
          acc[k][p][0] *= corr;
          acc[k][p][1] *= corr;
        }
      }
    }
#pragma unroll 8
    for (int tt = 0; tt < ch; ++tt) {
#pragma unroll
      for (int p = 0; p < P::PPT; ++p) {
        const float2 vv = widen2(vs + tt * P::LD + 2 * (dp + p * THREADS));
#pragma unroll
        for (int k = 0; k < GPV; ++k) {
          const int g = gq + P::GQ * k;
          if (g < GB) {
            const float pr = s_s[0][g][tt];
            acc[k][p][0] = fmaf(pr, vv.x, acc[k][p][0]);
            acc[k][p][1] = fmaf(pr, vv.y, acc[k][p][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();            // the last chunk's l_s / m_s are final

  const size_t unit = ((size_t)b * a.KV + kv) * a.smax + sp;  // this split
#pragma unroll
  for (int k = 0; k < GPV; ++k) {
    const int g = gq + P::GQ * k;
    if (g >= Gl) continue;
#pragma unroll
    for (int p = 0; p < P::PPT; ++p) {
      const int d = 2 * (dp + p * THREADS);   // d + 1 < hd too: hd is even
      if (d >= hd) continue;
      if (nsplit <= 1) {
        const float inv = 1.0f / fmaxf(l_s[g], 1e-30f);
        DT* o = static_cast<DT*>(a.out) +
                ((int64_t)b * a.H + kv * G + g0 + g) * hd;
        o[d] = from_f<DT>(acc[k][p][0] * inv);
        o[d + 1] = from_f<DT>(acc[k][p][1] * inv);
      } else {
        float* pa = a.part + (unit * G + g0 + g) * hd + d;
        pa[0] = acc[k][p][0];
        pa[1] = acc[k][p][1];
      }
    }
  }
  if (nsplit > 1 && tid < Gl) {
    float* ml = a.part + (size_t)gridDim.z * a.KV * a.smax * G * hd +
                (unit * G + g0 + tid) * 2;
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// The splits of each sequence with more than one, added in split order:
// out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30), w_s = exp(m_s - max m).
// One thread per output element; the loads of several splits in flight.
template <typename DT>
__global__ void __launch_bounds__(THREADS)
paged_combine(const PagedArgs a, int B) {
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = a.H / a.KV;
  const int e = blockIdx.z * THREADS + threadIdx.x;
  int lo, hi;
  const int nsplit = live_range(a.seq_lens[b], a.window, a.NP * a.T, a.L, lo,
                                hi);
  const int hd = a.hd;
  if (nsplit <= 1 || e >= G * hd) return;
  const int g = e / hd, d = e % hd;
  const size_t unit0 = ((size_t)b * a.KV + kv) * a.smax;
  const float* ml = a.part + (size_t)B * a.KV * a.smax * G * hd;
  float mx = NEG_INF;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    mx = fmaxf(mx, __ldg(ml + ((unit0 + s) * G + g) * 2));
  }
  float l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const size_t u = (unit0 + s) * G + g;
    const float w = expf(__ldg(ml + u * 2) - mx);
    l = fmaf(__ldg(ml + u * 2 + 1), w, l);
    acc = fmaf(__ldg(a.part + u * hd + d), w, acc);
  }
  static_cast<DT*>(a.out)[((int64_t)b * a.H + kv * G + g) * hd + d] =
      from_f<DT>(acc / fmaxf(l, 1e-30f));
}

template <typename DT, int HD, int GB>
int launch_g(const PagedArgs& a, int B, cudaStream_t st) {
  using P = Paged<DT, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<DT, HD, GB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  paged_attention_kernel<DT, HD, GB>
      <<<dim3(a.smax, a.KV * a.ngroups, B), THREADS, P::SMEM_BYTES, st>>>(a);
  if (a.smax > 1) {
    const int G = a.H / a.KV;
    paged_combine<DT>
        <<<dim3(a.KV, B, (G * a.hd + THREADS - 1) / THREADS), THREADS, 0,
           st>>>(a, B);
  }
  return (int)cudaGetLastError();
}

template <typename DT, int HD>
int launch_hd(PagedArgs a, int B, cudaStream_t st) {
  using P = Paged<DT, HD>;
  if (a.L <= 0 || a.L % P::CHUNK != 0 || a.L % a.T != 0 ||
      a.L / a.T + 2 > MAX_PAGES) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smax = ((long long)a.NP * a.T + a.L - 1) / a.L;
  if (smax > 65535 || (smax > 1) != (a.part != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  a.smax = (int)smax;
  const int G = a.H / a.KV;
  a.gsz = G < MAX_G ? G : MAX_G;
  a.ngroups = (G + a.gsz - 1) / a.gsz;
  if ((long long)a.KV * a.ngroups > 65535) return (int)cudaErrorInvalidValue;
  if (a.gsz <= 1) return launch_g<DT, HD, 1>(a, B, st);
  if (a.gsz <= 2) return launch_g<DT, HD, 2>(a, B, st);
  if (a.gsz <= 4) return launch_g<DT, HD, 4>(a, B, st);
  return launch_g<DT, HD, 8>(a, B, st);
}

// hd at the smallest compiled row width that holds it
// (kernels/paged_attention.py::padded_head_dim)
template <typename DT>
int launch(const PagedArgs& a, int B, int hd, cudaStream_t st) {
  if (hd <= 0 || hd % 8 != 0 || hd > 256) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return launch_hd<DT, 64>(a, B, st);
  if (hd <= 128) return launch_hd<DT, 128>(a, B, st);
  return launch_hd<DT, 256>(a, B, st);
}

// live_range of n sequences, for the tests: out[3 i ..] = lo, hi, splits
__global__ void split_plan(const int32_t* seq_lens, int n, int window,
                           int cap, int L, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int lo, hi;
  const int ns = live_range(seq_lens[i], window, cap, L, lo, hi);
  out[3 * i] = lo;
  out[3 * i + 1] = hi;
  out[3 * i + 2] = ns;
}

}  // namespace

// The kernels' live range and split count of n sequences: seq_lens [n] and
// out [n, 3] int32 on the card; window <= 0 means none, cap is the page
// table's NP * T, L the split length.
extern "C" int repro_paged_split_plan(const void* seq_lens, int n,
                                      int window, int cap, int L, void* out,
                                      void* stream) {
  if (n <= 0 || cap <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  split_plan<<<(n + THREADS - 1) / THREADS, THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seq_lens), n, window, cap, L,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// q [B, H, hd], k_pages and v_pages [P, T, KV, hd] and out in one dtype
// (0 = fp32, 1 = bf16), hd a multiple of 8 up to 256, any H / KV; page_table
// [B, NP] and seq_lens [B] int32; all contiguous, the pools 16-byte
// aligned. window <= 0 means no window, softcap <= 0 no softcap. split_len
// is L (kernels/paged_attention.py::split_len, a multiple of T and of the
// chunk); scratch holds B * KV * ceil(NP * T / L) * G * (hd + 2) floats when
// that split count exceeds 1, else it is null. Returns cudaGetLastError()
// after the launches (cudaErrorInvalidValue for a call the kernel does not
// take).
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* page_table,
                                     const void* seq_lens, void* out,
                                     void* scratch, int B, int H, int KV,
                                     int hd, int T, int NP, int split_len,
                                     float scale, int window, float softcap,
                                     int dtype, void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || KV > 65535 || H % KV != 0 ||
      T <= 0 || NP <= 0 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  PagedArgs a = {};
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.page_table = static_cast<const int32_t*>(page_table);
  a.seq_lens = static_cast<const int32_t*>(seq_lens);
  a.out = out;
  a.part = static_cast<float*>(scratch);
  a.H = H;
  a.KV = KV;
  a.T = T;
  a.NP = NP;
  a.L = split_len;
  a.hd = hd;
  a.scale = scale;
  a.window = window;
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, hd, st);
  return launch<float>(a, B, hd, st);
}
