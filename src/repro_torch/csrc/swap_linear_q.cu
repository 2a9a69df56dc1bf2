// swap_linear_q: fused dequant-matmul over a quantized-resident weight,
// y = act(x @ (qw * s) + b), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swap_linear_q.py (_qkernel,
// launched by swap_linear_q). It computes the same function; it is not a
// block-by-block copy of the Pallas grid.
//
// What bounds it on an H100: at decode (M = 2) the weight bytes, so the
// weight stays int8 (or int4 carrier) all the way into shared memory and is
// widened only in registers, never written back as fp. At prefill (M = 512)
// the arithmetic: this first version does it on the CUDA cores in fp32, so
// it is far from the tensor-core rate. wgmma, TMA and a split-K decode
// path are later work; this version is simple and right first.
//
// Design: one block of 256 threads per 64x64 output tile; the k-loop steps
// by 32. Each step stages the x tile (in x's dtype) and the weight tile
// (int8 rows, or 16 carrier rows at int4) in shared memory; each thread
// owns a 4x4 grid of fp32 accumulators (rows ty + 16 i, columns tx + 16 j)
// and sign-extends the weights it reads: low nibble (int8_t)(c << 4) >> 4
// for even k, c >> 4 for odd k. The per-channel scale factors out of the
// k-sum, so the epilogue applies it once: acc * s[n] + b[n], then silu
// (r * sigmoid(r)) or tanh-gelu, stored in x's dtype. Ragged M, N and K are
// masked with zeros at staging and at the store: no padded copies.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

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

template <int ACT> __device__ __forceinline__ float activate(float r) {
  if (ACT == 1) {                       // silu
    return r * (1.0f / (1.0f + expf(-r)));
  }
  if (ACT == 2) {                       // gelu, tanh approximation
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * r * (1.0f + tanhf(c * (r + 0.044715f * r * r * r)));
  }
  return r;
}

template <typename T, int BITS, int ACT>
__global__ void __launch_bounds__(THREADS)
swap_linear_q_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                     const float* __restrict__ scales,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int M, int N, int K) {
  constexpr int PACK = BITS == 4 ? 2 : 1;
  constexpr int BKQ = BK / PACK;        // weight rows staged per k-step
  // raw bytes, viewed as T: a __shared__ array of T itself would need T
  // to be trivially constructible
  __shared__ __align__(16) unsigned char xs_raw[BM * BK * sizeof(T)];
  __shared__ int8_t ws[BKQ][BN];
  T (*xs)[BK] = reinterpret_cast<T (*)[BK]>(xs_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int Kq = (K + PACK - 1) / PACK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : from_f<T>(0.0f);
    }
    const int q0 = k0 / PACK;
    for (int e = tid; e < BKQ * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gq = q0 + r, gn = n0 + c;
      ws[r][c] = (gq < Kq && gn < N) ? qw[(size_t)gq * N + gn] : (int8_t)0;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f<T>(xs[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t c = ws[kk / PACK][tx + 16 * j];
        int v;
        if (BITS == 4) {
          v = (kk & 1) ? (c >> 4) : ((int8_t)((uint8_t)c << 4) >> 4);
        } else {
          v = c;
        }
        w[j] = (float)v;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float r = acc[i][j] * scales[gn];
      if (bias != nullptr) r += bias[gn];
      out[(size_t)gm * N + gn] = from_f<T>(activate<ACT>(r));
    }
  }
}

template <typename T, int BITS>
void launch_act(const void* x, const void* qw, const void* s, const void* b,
                void* out, int M, int N, int K, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(qw);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  T* op = static_cast<T*>(out);
  if (act == 1) {
    swap_linear_q_kernel<T, BITS, 1><<<grid, THREADS, 0, stream>>>(xp, qp, sp, bp, op, M, N, K);
  } else if (act == 2) {
    swap_linear_q_kernel<T, BITS, 2><<<grid, THREADS, 0, stream>>>(xp, qp, sp, bp, op, M, N, K);
  } else {
    swap_linear_q_kernel<T, BITS, 0><<<grid, THREADS, 0, stream>>>(xp, qp, sp, bp, op, M, N, K);
  }
}

template <typename T>
void launch_bits(const void* x, const void* qw, const void* s, const void* b,
                 void* out, int M, int N, int K, int bits, int act,
                 cudaStream_t stream) {
  if (bits == 4) {
    launch_act<T, 4>(x, qw, s, b, out, M, N, K, act, stream);
  } else {
    launch_act<T, 8>(x, qw, s, b, out, M, N, K, act, stream);
  }
}

}  // namespace

// x_dtype: 0 = fp32, 1 = bf16; bits: 8 or 4; act: 0 none, 1 silu, 2 gelu.
// bias may be null. Returns cudaGetLastError() after the launch.
extern "C" int repro_swap_linear_q(const void* x, const void* qw,
                                   const void* scales, const void* bias,
                                   void* out, int M, int N, int K, int x_dtype,
                                   int bits, int act, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (bits != 8 && bits != 4) ||
      act < 0 || act > 2 || x_dtype < 0 || x_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) {
    launch_bits<__nv_bfloat16>(x, qw, scales, bias, out, M, N, K, bits, act, st);
  } else {
    launch_bits<float>(x, qw, scales, bias, out, M, N, K, bits, act, st);
  }
  return (int)cudaGetLastError();
}
