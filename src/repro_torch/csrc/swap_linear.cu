// swap_linear: the full-precision weight-streaming matmul,
// y = act(x @ w + b), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swap_linear.py (_kernel,
// launched by swap_linear). It computes the same function; it is not a
// block-by-block copy of the Pallas grid.
//
//   x [M, K] and w [K, N], both fp32 or both bf16; b [N] fp32 or null
//   -> y [M, N] in their dtype.
//
// What bounds it on an H100: at prefill (M in the hundreds or thousands)
// the arithmetic, 2 M N K flops; at decode (M = 1..4) the weight bytes.
// This first version runs both on the CUDA cores in fp32, so it is far
// from the tensor-core rate at prefill; wgmma, TMA and a decode path that
// splits N more finely are later work. fp32 inputs must stay within 1e-5
// of the plain version, which rules out TF32 and bf16 tensor cores for
// them.
//
// Design: the same tiling as csrc/swap_linear_q.cu without the dequant.
// One block of 256 threads per 64x64 output tile; the k-loop steps by 32,
// staging the x tile and the w tile in shared memory in the input dtype;
// each thread owns a 4x4 grid of fp32 accumulators (rows ty + 16 i,
// columns tx + 16 j). Bias and the silu (r * sigmoid(r)) or tanh-gelu
// activation are applied once at the flush, in fp32. Ragged M, N and K
// are masked with zeros at staging and at the store: no padded copies.
//
// Determinism and row independence: no split-K, no atomics, and one tile
// shape for every M, so the fma chain that produces y[m, n] is the same
// whatever M is. Row i of an M-row call equals, bitwise, the 1-row call on
// that row: paged batched decode (M = batch) reproduces solo runs (M = 1).
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

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
swap_linear_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int M, int N, int K) {
  // raw bytes, viewed as T: a __shared__ array of bf16 itself would need
  // the type to be trivially constructible
  __shared__ __align__(16) unsigned char xs_raw[BM * BK * sizeof(T)];
  __shared__ __align__(16) unsigned char ws_raw[BK * BN * sizeof(T)];
  T (*xs)[BK] = reinterpret_cast<T (*)[BK]>(xs_raw);
  T (*ws)[BN] = reinterpret_cast<T (*)[BN]>(ws_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

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
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : from_f<T>(0.0f);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f<T>(xs[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f<T>(ws[kk][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
      float r = acc[i][j];
      if (bias != nullptr) r += bias[gn];
      out[(size_t)gm * N + gn] = from_f<T>(activate<ACT>(r));
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int M,
            int N, int K, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* bp = static_cast<const float*>(b);
  T* op = static_cast<T*>(out);
  if (act == 1) {
    swap_linear_kernel<T, 1><<<grid, THREADS, 0, stream>>>(xp, wp, bp, op, M, N, K);
  } else if (act == 2) {
    swap_linear_kernel<T, 2><<<grid, THREADS, 0, stream>>>(xp, wp, bp, op, M, N, K);
  } else {
    swap_linear_kernel<T, 0><<<grid, THREADS, 0, stream>>>(xp, wp, bp, op, M, N, K);
  }
}

}  // namespace

// dtype (of x, w and out): 0 = fp32, 1 = bf16; act: 0 none, 1 silu,
// 2 gelu. bias (fp32) may be null. The grid's y extent caps M at
// 65535 * 64 rows. Returns cudaGetLastError() after the launch.
extern "C" int repro_swap_linear(const void* x, const void* w,
                                 const void* bias, void* out, int M, int N,
                                 int K, int dtype, int act, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + BM - 1) / BM > 65535 || act < 0 ||
      act > 2 || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, bias, out, M, N, K, act, st);
  } else {
    launch<float>(x, w, bias, out, M, N, K, act, st);
  }
  return (int)cudaGetLastError();
}
