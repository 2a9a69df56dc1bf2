// flash_attention: prefill self-attention with an online softmax, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// launched by flash_attention). It computes the same function with the
// generality the port's prefill needs; it is not a block-by-block copy of
// the Pallas grid.
//
//   q [B, S, H, hd], k and v [B, S, KV, hd] (the projections' layout, one
//   dtype, fp32 or bf16); q_pos [B, S] int32 -> out [B, S, H, hd] in q's
//   dtype.
//
// Semantics (those of the port's models/attention.py::online_attention
// with no kv_valid_len): key j (its index) attends to a query at position
// p = q_pos[b, i] iff, when causal, j <= p and p - j < window; a
// non-causal call masks nothing. Query head h reads KV head h / (H / KV)
// directly: no repeated K/V copies. A score is q.k * scale, then the
// softcap (cap * tanh(s / cap)), then the mask, whose value is the finite
// NEG_INF = -0.7 * f32max; the softmax runs online over KV tiles with the
// running (m, l, acc) in fp32 and l clamped at 1e-30 at the end. S need
// not be a multiple of any tile: the ragged tail is masked in the kernel.
//
// Block skip, as the TPU kernel's, taken from q_pos: a query tile visits
// only the KV tiles that hold a key some of its rows may attend to, the
// tiles from the one holding min(q_pos) - window + 1 up to the one holding
// max(q_pos). A skipped tile would add exp(NEG_INF - m) = 0 to every row,
// so the result is that of the unskipped scan for every row that has a
// key to attend to (any row with 0 <= q_pos < S).
//
// What bounds it on an H100: operations, about 4 hd flops per (query,
// key, head) pair that is not skipped, against reading q, k, v once and
// writing out once. This first version runs them on the CUDA cores in
// fp32 (fp32 inputs must stay within 1e-5 of the plain version: no TF32),
// so it is far from the tensor cores' rate; wgmma and TMA are later work.
//
// Design: one block of 256 threads per (32 query rows, head, batch); a
// group of 8 threads owns one row: its q (hd / 8 columns a thread, in
// registers, columns t + 8 i so that a group reads 8 neighbouring words of
// shared memory) and its fp32 accumulator. The block stages each KV tile
// of 32 keys (K and V, in the input dtype, zero past hd and past S) in
// dynamic shared memory: 64 KB at hd 256 in fp32, above the 48 KB default,
// so the launch raises the block's limit first. Each score's hd-long dot
// product is split over the group's 8 threads and summed with three xor
// shuffles, which leave every thread of the group the same bits. Then
// every thread of the group runs the same online-softmax update for its
// row: tile max, correction exp(m - m_new), p = exp(s - m_new), l and its
// acc columns. No atomics, no split over keys: deterministic, so swapped
// and unswapped passes agree bitwise.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 8;                  // threads per query row
constexpr int THREADS = 256;
constexpr int BQ = THREADS / GROUP;       // query rows per block
constexpr int BKV = 32;                   // keys per staged tile
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

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

template <typename T, int HD_MAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ q_pos, T* __restrict__ out,
                       int S, int H, int KV, int hd, float scale, int causal,
                       int window, float softcap) {
  constexpr int NCOL = HD_MAX / GROUP;    // columns a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);             // [BKV][HD_MAX]
  T* vs = ks + BKV * HD_MAX;                          // [BKV][HD_MAX]
  __shared__ int red_min[THREADS / 32];
  __shared__ int red_max[THREADS / 32];

  const int tid = threadIdx.x;
  const int row = tid / GROUP;
  const int t = tid % GROUP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int i = blockIdx.x * BQ + row;                // query index
  const bool row_ok = i < S;

  float qr[NCOL], acc[NCOL];
  const size_t q_base = (((size_t)b * S + (row_ok ? i : 0)) * H + h) * hd;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int col = t + GROUP * c;
    qr[c] = (row_ok && col < hd) ? to_f<T>(q[q_base + col]) : 0.0f;
    acc[c] = 0.0f;
  }
  const int qp = row_ok ? q_pos[(size_t)b * S + i] : 0;

  // the tile's smallest and largest q_pos over its real rows
  int lo = row_ok ? qp : INT32_MAX;
  int hi = row_ok ? qp : INT32_MIN;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (tid % 32 == 0) {
    red_min[tid / 32] = lo;
    red_max[tid / 32] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    lo = min(lo, red_min[w]);
    hi = max(hi, red_max[w]);
  }

  // KV tiles to visit: [kv_lo, kv_hi) holds every key a row may attend to
  long long kv_lo = 0, kv_hi = S;
  if (causal) {
    kv_hi = min((long long)S, (long long)hi + 1);
    if (window > 0) kv_lo = max(0LL, (long long)lo - window + 1);
  }

  float m = NEG_INF, l = 0.0f;
  for (long long j0 = kv_lo / BKV * BKV; j0 < kv_hi; j0 += BKV) {
    const int nk = (int)min((long long)BKV, (long long)S - j0);
    __syncthreads();                      // the last tile's reads are done
    for (int e = tid; e < BKV * HD_MAX; e += THREADS) {
      const int r = e / HD_MAX, c = e % HD_MAX;
      T kv_k = from_f<T>(0.0f), kv_v = from_f<T>(0.0f);
      if (r < nk && c < hd) {
        const size_t off = (((size_t)b * S + j0 + r) * KV + kvh) * hd + c;
        kv_k = k[off];
        kv_v = v[off];
      }
      ks[e] = kv_k;
      vs[e] = kv_v;
    }
    __syncthreads();

    float s[BKV];
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        d = fmaf(qr[c], to_f<T>(ks[jj * HD_MAX + t + GROUP * c]), d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      float sc = d * scale;
      if (softcap > 0.0f) sc = softcap * tanhf(sc / softcap);
      const long long j = j0 + jj;
      bool ok = true;
      if (causal) {
        ok = j <= qp && (window <= 0 || (long long)qp - j < window);
      }
      s[jj] = ok ? sc : NEG_INF;
    }
    float m_tile = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      if (jj < nk) m_tile = fmaxf(m_tile, s[jj]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[c] *= corr;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      if (jj < nk) {
        const float p = expf(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          acc[c] = fmaf(p, to_f<T>(vs[jj * HD_MAX + t + GROUP * c]), acc[c]);
        }
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int col = t + GROUP * c;
    if (col < hd) out[q_base + col] = from_f<T>(acc[c] * inv);
  }
}

template <typename T, int HD_MAX>
int launch_hd(const void* q, const void* k, const void* v, const void* qpos,
              void* out, int B, int S, int H, int KV, int hd, float scale,
              int causal, int window, float softcap, cudaStream_t st) {
  const size_t smem = 2 * (size_t)BKV * HD_MAX * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD_MAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD_MAX><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(qpos),
      static_cast<T*>(out), S, H, KV, hd, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           void* out, int B, int S, int H, int KV, int hd, float scale,
           int causal, int window, float softcap, cudaStream_t st) {
  if (hd <= 64) {
    return launch_hd<T, 64>(q, k, v, qpos, out, B, S, H, KV, hd, scale,
                            causal, window, softcap, st);
  }
  if (hd <= 128) {
    return launch_hd<T, 128>(q, k, v, qpos, out, B, S, H, KV, hd, scale,
                             causal, window, softcap, st);
  }
  return launch_hd<T, 256>(q, k, v, qpos, out, B, S, H, KV, hd, scale,
                           causal, window, softcap, st);
}

}  // namespace

// q, k, v and out in one dtype (0 = fp32, 1 = bf16), contiguous; q_pos
// int32 [B, S]. causal: 0 or 1; window <= 0 means no window (it applies
// only when causal), softcap <= 0 no softcap; 1 <= hd <= 256. Returns the
// first CUDA error of the launch, or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, const void* q_pos,
                                     void* out, int B, int S, int H, int KV,
                                     int hd, float scale, int causal,
                                     int window, float softcap, int dtype,
                                     void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || KV <= 0 ||
      H % KV != 0 || hd <= 0 || hd > 256 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, q_pos, out, B, S, H, KV, hd, scale,
                                 causal, window, softcap, st);
  }
  return launch<float>(q, k, v, q_pos, out, B, S, H, KV, hd, scale, causal,
                       window, softcap, st);
}
