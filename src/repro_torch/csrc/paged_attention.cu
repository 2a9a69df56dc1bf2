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
// online softmax (m, l, acc) runs in fp32; l is clamped at 1e-30. A page
// past the sequence (j * T >= seq_len) or wholly out of the window
// (j * T + T - 1 < q_pos - (window - 1)) is skipped and never read, so the
// padding page 0 never reaches the softmax.
//
// Translation: the TPU grid (B, KV, NP) runs in order on one core and
// carries (m, l, acc) in VMEM across the page axis. Here one block owns
// one (sequence, KV head) pair and walks that sequence's pages in a loop,
// so the statistics stay in the block; the block reads its own page-table
// row and seq_len (the TPU's scalar prefetch). Pages are staged CHUNK
// tokens at a time (any T). The chunks a sequence needs are one
// contiguous run, from the one holding the oldest in-window token to the
// one holding the query, so the loop walks exactly that run. Each thread
// loads its share of the next chunk's K and V rows in 16-byte vectors
// into registers while the block computes the current chunk from shared
// memory (fp32), so a chunk's load latency hides behind the previous
// chunk's work. Scores: each warp takes CHUNK / WARPS tokens for all G
// query heads, lanes split hd, and the partial dot products of all its
// (token, head) pairs reduce together in interleaved shuffles. The
// softmax step gives one warp per head; the accumulators [G, hd] live in
// registers. G is bucketed to a compile-time GB in {1, 2, 4, 8}.
//
// What bounds it on an H100: bytes. Each live, in-window K/V page is read
// once per KV head (2 * T * hd * itemsize bytes), against 4 * G * hd
// flops per token: far below the card's ratio of flops to bytes. The
// design reads only live in-window pages and reads each K/V row exactly
// once for all G heads that share it. What it does not do yet: split a
// long sequence across blocks (flash-decoding). A decode batch of B
// sequences fills only B * KV blocks of the 132 SMs, so a long sequence
// runs on one SM, chunk after chunk; that split is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int CHUNK = 16;                     // tokens staged at a time (<= 32)
constexpr int TPW = CHUNK / WARPS;            // tokens per warp in the scores
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

// 16 bytes of DT widened to fp32 and stored to shared memory
__device__ __forceinline__ void store_vec(float* dst, uint4 v, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<float4*>(&v);
}
__device__ __forceinline__ void store_vec(float* dst, uint4 v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

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

template <typename DT, int HD, int GB>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const DT* __restrict__ q, const DT* __restrict__ kp,
                       const DT* __restrict__ vp,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ seq_lens,
                       DT* __restrict__ out, int H, int KV, int T, int NP,
                       float scale, int window, float softcap) {
  constexpr int ACC = (GB * HD + THREADS - 1) / THREADS;  // acc slots/thread
  constexpr int VEC = 16 / sizeof(DT);        // elements per 16-byte load
  constexpr int ROW_V = HD / VEC;             // 16-byte vectors per row
  constexpr int NV = CHUNK * ROW_V / THREADS; // vectors per thread per chunk
  constexpr int DPL = HD / 32;                // head-dim slots per lane
  static_assert(CHUNK * ROW_V % THREADS == 0, "chunk must split evenly");
  static_assert(TPW * GB <= 32, "one lane per (token, head) pair");
  __shared__ __align__(16) float q_s[GB][HD];
  __shared__ __align__(16) float k_s[CHUNK][HD];
  __shared__ __align__(16) float v_s[CHUNK][HD];
  __shared__ float s_s[GB][CHUNK];
  __shared__ float m_s[GB], l_s[GB], corr_s[GB];

  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int seq_len = seq_lens[b];
  const int q_pos = seq_len - 1;
  const int lo_tok = window > 0 ? q_pos - (window - 1) : 0;  // oldest in window
  // the chunks holding live in-window tokens: one contiguous run
  const int cpp = (T + CHUNK - 1) / CHUNK;    // chunks per page
  int c_first = 0, c_last = -1;
  if (seq_len > 0) {
    const int lo = lo_tok > 0 ? lo_tok : 0;
    c_first = (lo / T) * cpp + (lo % T) / CHUNK;
    c_last = (q_pos / T) * cpp + (q_pos % T) / CHUNK;
    if (q_pos / T >= NP) c_last = NP * cpp - 1;
  }

  for (int e = tid; e < GB * HD; e += THREADS) {
    const int g = e / HD, d = e % HD;    // rows past G stay zero
    q_s[g][d] = g < G ? to_f<DT>(q[((int64_t)b * H + kv * G + g) * HD + d])
                      : 0.f;
  }
  if (tid < GB) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  __syncthreads();

  const int32_t* row = page_table + (int64_t)b * NP;
  const int64_t tok_stride = (int64_t)KV * HD;       // between slots of a page
  uint4 kr[NV], vr[NV];
  // start the 16-byte loads of chunk ci into kr / vr (zeros past the page)
  auto prefetch = [&](int ci) {
    const int c0 = (ci % cpp) * CHUNK;
    const int ch = min(CHUNK, T - c0);
    const int64_t base =
        ((int64_t)row[ci / cpp] * T + c0) * tok_stride + (int64_t)kv * HD;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * THREADS;
      const int t = e / ROW_V, dv = e % ROW_V;
      if (t < ch) {
        const int64_t off = base + t * tok_stride + dv * VEC;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kp + off));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(vp + off));
      } else {
        kr[i] = make_uint4(0u, 0u, 0u, 0u);
        vr[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  if (c_first <= c_last) prefetch(c_first);

  for (int ci = c_first; ci <= c_last; ++ci) {
    const int c0 = (ci % cpp) * CHUNK;
    const int ch = min(CHUNK, T - c0);
    const int t_lo = (ci / cpp) * T + c0;     // first token of the chunk
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * THREADS;
      const int t = e / ROW_V, dv = e % ROW_V;
      store_vec(&k_s[t][dv * VEC], kr[i], DT());
      store_vec(&v_s[t][dv * VEC], vr[i], DT());
    }
    __syncthreads();
    if (ci < c_last) prefetch(ci + 1);        // lands while this chunk runs

    // scores: warp w takes tokens w, w + WARPS, ...; all heads at once
    float part[TPW][GB];
#pragma unroll
    for (int r = 0; r < TPW; ++r)
#pragma unroll
      for (int g = 0; g < GB; ++g) part[r][g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      float kd[TPW];
#pragma unroll
      for (int r = 0; r < TPW; ++r) kd[r] = k_s[warp + WARPS * r][d];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float qd = q_s[g][d];
#pragma unroll
        for (int r = 0; r < TPW; ++r) part[r][g] += qd * kd[r];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < TPW; ++r)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          part[r][g] += __shfl_xor_sync(0xffffffffu, part[r][g], o);
    {
      // every lane holds every sum: lane r * GB + g finishes pair (r, g)
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < TPW; ++r)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          if (lane == r * GB + g) dot = part[r][g];
      const int r = lane / GB, g = lane % GB;
      const int t = warp + WARPS * r;
      if (r < TPW && g < G && t < ch) {
        float s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int tok = t_lo + t;
        const bool ok = tok < seq_len && (window <= 0 || q_pos - tok < window);
        s_s[g][t] = ok ? s : NEG_INF;
      }
    }
    __syncthreads();
    // online softmax: one warp per query head, one lane per token
    for (int g = warp; g < G; g += WARPS) {
      const float s = lane < ch ? s_s[g][lane] : NEG_INF;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < ch ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (lane < ch) s_s[g][lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();
    // acc[g, d] = acc * corr + sum_t p[g, t] * v[t, d]
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * THREADS;
      const int g = e / HD, d = e % HD;
      if (g < G) {
        float a = acc[i] * corr_s[g];
        for (int t = 0; t < ch; ++t) a += s_s[g][t] * v_s[t][d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * THREADS;
    const int g = e / HD, d = e % HD;
    if (g < G) {
      out[((int64_t)b * H + kv * G + g) * HD + d] =
          from_f<DT>(acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename DT, int HD>
void launch_hd(const DT* q, const DT* k, const DT* v, const int32_t* pt,
               const int32_t* sl, DT* out, int B, int H, int KV, int T,
               int NP, float scale, int window, float softcap,
               cudaStream_t st) {
  const dim3 grid(KV, B);
  const int G = H / KV;
  if (G <= 1) {
    paged_attention_kernel<DT, HD, 1><<<grid, THREADS, 0, st>>>(
        q, k, v, pt, sl, out, H, KV, T, NP, scale, window, softcap);
  } else if (G <= 2) {
    paged_attention_kernel<DT, HD, 2><<<grid, THREADS, 0, st>>>(
        q, k, v, pt, sl, out, H, KV, T, NP, scale, window, softcap);
  } else if (G <= 4) {
    paged_attention_kernel<DT, HD, 4><<<grid, THREADS, 0, st>>>(
        q, k, v, pt, sl, out, H, KV, T, NP, scale, window, softcap);
  } else {
    paged_attention_kernel<DT, HD, 8><<<grid, THREADS, 0, st>>>(
        q, k, v, pt, sl, out, H, KV, T, NP, scale, window, softcap);
  }
}

template <typename DT>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* sl, void* out, int B, int H, int KV, int hd, int T,
           int NP, float scale, int window, float softcap, cudaStream_t st) {
  const DT* qp = static_cast<const DT*>(q);
  const DT* kp = static_cast<const DT*>(k);
  const DT* vp = static_cast<const DT*>(v);
  const int32_t* ptp = static_cast<const int32_t*>(pt);
  const int32_t* slp = static_cast<const int32_t*>(sl);
  DT* op = static_cast<DT*>(out);
  switch (hd) {
    case 64:
      launch_hd<DT, 64>(qp, kp, vp, ptp, slp, op, B, H, KV, T, NP, scale,
                        window, softcap, st);
      break;
    case 128:
      launch_hd<DT, 128>(qp, kp, vp, ptp, slp, op, B, H, KV, T, NP, scale,
                         window, softcap, st);
      break;
    case 256:
      launch_hd<DT, 256>(qp, kp, vp, ptp, slp, op, B, H, KV, T, NP, scale,
                         window, softcap, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k_pages, v_pages and out in one dtype (0 = fp32, 1 = bf16); page_table
// [B, NP] and seq_lens [B] int32; all contiguous, the pools 16-byte
// aligned. window <= 0 means no
// window, softcap <= 0 no softcap. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* page_table,
                                     const void* seq_lens, void* out, int B,
                                     int H, int KV, int hd, int T, int NP,
                                     float scale, int window, float softcap,
                                     int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAX_G || T <= 0 ||
      NP <= 0 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, seq_lens,
                                 out, B, H, KV, hd, T, NP, scale, window,
                                 softcap, st);
  }
  return launch<float>(q, k_pages, v_pages, page_table, seq_lens, out, B, H,
                       KV, hd, T, NP, scale, window, softcap, st);
}
