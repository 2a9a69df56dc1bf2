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
// zeros and dropping it at the end. Here one block owns one (b, h) row and
// walks its chunks in a loop, with S [hd, hd] resident in shared memory;
// the block starts from s0 and writes the final state, which decode and
// the serving paths need. Each chunk's r, k, v and w tiles ([Q, hd], one
// 4-element vector per thread and tensor) are loaded into registers while
// the block computes the previous chunk, then widened to fp32 in shared
// memory. Threads: 4 * hd. Step 1 (hd threads, one channel each) runs the
// cumulative sum and the decay factors; step 2 forms the Q x Q matrix A,
// its diagonal holding the bonus sum_c r u k; step 3 gives each thread one
// output column j and four of the Q rows (y needs A, v and S); step 4
// updates the state, each thread one column j and hd / 4 rows. Five
// barriers a chunk, no atomics: deterministic, so swapped and unswapped
// runs agree bitwise.
//
// What bounds it on an H100: bytes. The function reads r, k, v, w once and
// writes y once (5 * BH * S * hd elements) against about 4 * hd flops per
// element (the r S and k^T v products), below the card's ratio of fp32
// flops to bytes. This design is latency-bound instead: BH blocks (80 at
// rwkv6-3b's prefill) walk S / Q chunks one after another on 80 of the 132
// SMs. The state's columns evolve independently, so a later version can
// split a head's hd columns across blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;                     // Q at most (RWKV_CHUNK)

template <typename T> struct Vec4;            // four elements, one load
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void widen(const float4& v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void widen(const uint2& v, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
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

template <typename T, int HD>
__global__ void __launch_bounds__(4 * HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ s_out, int S, int Q) {
  constexpr int THREADS = 4 * HD;
  constexpr int P = HD + 1;                   // padded row of a [Q, hd] tile
  constexpr int AP = CHUNK + 1;
  using V4 = typename Vec4<T>::type;

  __shared__ float R[CHUNK * P];              // r, then r e^lprev
  __shared__ float K[CHUNK * P];              // k, then k e^-l
  __shared__ float Vt[CHUNK * P];             // v
  __shared__ float W[CHUNK * P];              // w_log, then r u k
  __shared__ float KT[CHUNK * P];             // k e^{l_Q - l}
  __shared__ float A[CHUNK * AP];
  __shared__ float St[HD * HD];               // state [hd_k, hd_v]
  __shared__ float U[HD];
  __shared__ float DEC[HD];                   // e^{l_Q}

  const int tid = threadIdx.x;
  const int j = tid % HD;                     // column of y and of S
  const int g = tid / HD;                     // 0..3
  const size_t base = (size_t)blockIdx.x * S * HD;

  const float* s0_row = s0 ? s0 + (size_t)blockIdx.x * HD * HD : nullptr;
  for (int e = tid; e < HD * HD; e += THREADS) St[e] = s0_row ? s0_row[e] : 0.f;
  if (tid < HD) U[tid] = to_f<T>(u[(size_t)blockIdx.x * HD + tid]);

  const int n_chunks = S / Q;
  const int tile = Q * HD;
  const int e0 = 4 * tid;                     // 4 | HD: one row, 4 columns
  const bool loads = e0 < tile;
  const int lt = e0 / HD, lc = e0 % HD;
  V4 pr, pk, pv, pw;
  if (loads) {
    pr = *reinterpret_cast<const V4*>(r + base + e0);
    pk = *reinterpret_cast<const V4*>(k + base + e0);
    pv = *reinterpret_cast<const V4*>(v + base + e0);
    pw = *reinterpret_cast<const V4*>(w + base + e0);
  }

  for (int c = 0; c < n_chunks; ++c) {
    const size_t off = base + (size_t)c * tile;
    if (loads) {
      float f[4];
      widen(pr, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) R[lt * P + lc + i] = f[i];
      widen(pk, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) K[lt * P + lc + i] = f[i];
      widen(pv, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) Vt[lt * P + lc + i] = f[i];
      widen(pw, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) W[lt * P + lc + i] = f[i];
      if (c + 1 < n_chunks) {                 // the next chunk, in flight
        const size_t nx = off + tile + e0;
        pr = *reinterpret_cast<const V4*>(r + nx);
        pk = *reinterpret_cast<const V4*>(k + nx);
        pv = *reinterpret_cast<const V4*>(v + nx);
        pw = *reinterpret_cast<const V4*>(w + nx);
      }
    }
    __syncthreads();

    // 1. per channel: l = cumsum(w), the decayed r and k, the bonus terms
    if (tid < HD) {
      const int ch = tid;
      const float uc = U[ch];
      float l[CHUNK];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        if (t < Q) {
          const float lw = W[t * P + ch];
          acc += lw;
          l[t] = acc;
          const float rv = R[t * P + ch];
          W[t * P + ch] = rv * (uc * K[t * P + ch]);
          R[t * P + ch] = rv * expf(acc - lw);
        }
      }
      const float lq = acc;
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) {
        if (t < Q) {
          const float kv = K[t * P + ch];
          K[t * P + ch] = kv * expf(-l[t]);
          KT[t * P + ch] = kv * expf(lq - l[t]);
        }
      }
      DEC[ch] = expf(lq);
    }
    __syncthreads();

    // 2. A[t, i] = (r e^lprev)_t . (k e^-l)_i for i < t; A[t, t] = the bonus
    for (int p = tid; p < Q * Q; p += THREADS) {
      const int t = p / Q, i = p % Q;
      float a = 0.f;
      if (i < t) {
#pragma unroll 8
        for (int ch = 0; ch < HD; ++ch) a += R[t * P + ch] * K[i * P + ch];
      } else if (i == t) {
#pragma unroll 8
        for (int ch = 0; ch < HD; ++ch) a += W[t * P + ch];
      }
      A[t * AP + i] = a;
    }
    __syncthreads();

    // 3. y[t, j] = sum_{i <= t} A[t, i] v[i, j] + sum_c (r e^lprev)[t, c] S[c, j]
    {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < Q; ++i) {
        const float vij = Vt[i * P + j];
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int t = g + 4 * q4;
          if (t < Q && i <= t) acc[q4] += A[t * AP + i] * vij;
        }
      }
#pragma unroll 4
      for (int ch = 0; ch < HD; ++ch) {
        const float s = St[ch * HD + j];
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int t = g + 4 * q4;
          if (t < Q) acc[q4] += R[t * P + ch] * s;
        }
      }
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int t = g + 4 * q4;
        if (t < Q) y[off + (size_t)t * HD + j] = from_f<T>(acc[q4]);
      }
    }
    __syncthreads();

    // 4. S[c, j] <- e^{l_Q}[c] S[c, j] + sum_t (k e^{l_Q - l})[t, c] v[t, j]
    {
      float vt[CHUNK];
#pragma unroll
      for (int t = 0; t < CHUNK; ++t) vt[t] = t < Q ? Vt[t * P + j] : 0.f;
      for (int rr = 0; rr < HD / 4; ++rr) {
        const int ch = g + 4 * rr;
        float kv = 0.f;
#pragma unroll
        for (int t = 0; t < CHUNK; ++t) {
          if (t < Q) kv += KT[t * P + ch] * vt[t];
        }
        St[ch * HD + j] = DEC[ch] * St[ch * HD + j] + kv;
      }
    }
    __syncthreads();
  }

  float* so = s_out + (size_t)blockIdx.x * HD * HD;
  for (int e = tid; e < HD * HD; e += THREADS) so[e] = St[e];
}

template <typename T, int HD>
void launch(const void* r, const void* k, const void* v, const void* w,
            const void* u, const void* s0, void* y, void* s_out, int BH,
            int S, int Q, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<BH, 4 * HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), S, Q);
}

template <typename T>
void launch_hd(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s_out, int BH,
               int S, int Q, int hd, cudaStream_t stream) {
  if (hd == 64) {
    launch<T, 64>(r, k, v, w, u, s0, y, s_out, BH, S, Q, stream);
  } else {
    launch<T, 32>(r, k, v, w, u, s0, y, s_out, BH, S, Q, stream);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (r, k, v, w_log, u and y); hd: 32 or 64;
// S % min(16, S) == 0; s0 may be null (zeros). Every pointer 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w_log, const void* u, const void* s0,
                          void* y, void* s_out, int BH, int S, int hd,
                          int dtype, void* stream) {
  const int Q = S < CHUNK ? S : CHUNK;
  if (BH <= 0 || S <= 0 || S % Q != 0 || (hd != 32 && hd != 64) ||
      dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_hd<__nv_bfloat16>(r, k, v, w_log, u, s0, y, s_out, BH, S, Q, hd, st);
  } else {
    launch_hd<float>(r, k, v, w_log, u, s0, y, s_out, BH, S, Q, hd, st);
  }
  return (int)cudaGetLastError();
}
