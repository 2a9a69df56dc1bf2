// swap_linear: the full-precision weight-streaming matmul,
// y = act(x @ w + b), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swap_linear.py (_kernel,
// launched by swap_linear). It computes the same function; it is not a
// block-by-block copy of the Pallas grid.
//
//   x [M, K] and w [K, N], both fp32 or both bf16; b [N] fp32, bf16 or
//   null -> y [M, N] in x's dtype.
//
// What bounds it on an H100: at prefill the arithmetic (2 M N K flops), at
// decode the weight bytes. bf16 runs the tensor-core core of sm90_gemm.cuh
// (TMA ring, wgmma on 128 x 128 tiles); fp32 runs its three-pass TF32 core
// (cp.async ring, mma.sync with each operand split into TF32 hi and lo,
// row tile 16, 64 or 128), which holds fp32 inputs within 1e-5 of the plain
// version where one TF32 pass would not. K is split where the output tiles
// alone leave SMs idle, by a count that depends on (N, K, dtype) only, so
// row i of an M-row call equals the 1-row call on that row bitwise
// (sm90_gemm.cuh says how).
#include "sm90_gemm.cuh"

// dtype (of x, w and out): 0 = fp32, 1 = bf16; act: 0 none, 1 silu,
// 2 gelu. bias may be null; bias_dtype: 0 = fp32, 1 = bf16. splits,
// block_m, combine (0 none, 1 serial, 2 blocks) and route are the launch
// plan of kernels/gemm_plan.py, which the kernel checks but does not
// choose. When the plan combines splits across blocks, scratch is its fp32
// partial buffer ([splits, M, N rounded up to a multiple of 4]) and
// counters 132 int32 zeros that the kernel leaves zero; else both are
// null. Returns a cudaError_t code: cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan the kernel cannot take.
extern "C" int repro_swap_linear(const void* x, const void* w,
                                 const void* bias, void* out, void* scratch,
                                 void* counters, int M, int N, int K,
                                 int dtype, int act, int bias_dtype,
                                 int splits, int block_m, int combine,
                                 int route, void* stream) {
  if (bias_dtype < 0 || bias_dtype > 1) return (int)cudaErrorInvalidValue;
  GemmArgs a = {x, w, nullptr, bias, out, static_cast<float*>(scratch),
                static_cast<int*>(counters), M, N, K, act, bias_dtype,
                splits, combine, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run_tc<W_FP>(a, block_m, route, st);
  if (dtype == 0) return run_tf32(a, block_m, route, st);
  return (int)cudaErrorInvalidValue;
}
