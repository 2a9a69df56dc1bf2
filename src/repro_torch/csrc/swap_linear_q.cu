// swap_linear_q: fused dequant-matmul over a quantized-resident weight,
// y = act(x @ (qw * s) + b), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swap_linear_q.py (_qkernel,
// launched by swap_linear_q). It computes the same function; it is not a
// block-by-block copy of the Pallas grid.
//
// What bounds it on an H100: at decode (M = 1..4) the weight bytes, so the
// weight stays int8 (or the int4 carrier) all the way into shared memory and
// is widened to bf16 (bf16 x) or fp32 (fp32 x) only there and in registers,
// never written back as fp to device memory; at prefill the arithmetic.
// bf16 x runs the tensor-core core of sm90_gemm.cuh: TMA brings the
// quantized tile, the consumers widen it into the swizzled bf16 layout the
// wgmma descriptor reads. fp32 x runs its CUDA-core core. The per-channel
// scale factors out of the k-sum, so the epilogue applies it once:
// acc * s[n] + b[n], then silu or tanh-gelu, stored in x's dtype. K is split
// by a count that depends on (N, K, dtype) only, so rows do not depend on M.
#include "sm90_gemm.cuh"

// x_dtype: 0 = fp32, 1 = bf16; bits: 8 or 4; act: 0 none, 1 silu, 2 gelu.
// bias may be null; bias_dtype, splits, block_m, combine, route, scratch
// and counters as in repro_swap_linear. Returns a cudaError_t code.
extern "C" int repro_swap_linear_q(const void* x, const void* qw,
                                   const void* scales, const void* bias,
                                   void* out, void* scratch, void* counters,
                                   int M, int N, int K, int x_dtype, int bits,
                                   int act, int bias_dtype, int splits,
                                   int block_m, int combine, int route,
                                   void* stream) {
  if (scales == nullptr || (bits != 8 && bits != 4) || x_dtype < 0 ||
      x_dtype > 1 || bias_dtype < 0 || bias_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  GemmArgs a = {x, qw, static_cast<const float*>(scales), bias, out,
                static_cast<float*>(scratch), static_cast<int*>(counters),
                M, N, K, act, bias_dtype, splits, combine, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1) {
    return bits == 8 ? run_tc<W_INT8>(a, block_m, route, st)
                     : run_tc<W_INT4>(a, block_m, route, st);
  }
  return bits == 8 ? run_simt<W_INT8>(a, block_m, route, st)
                   : run_simt<W_INT4>(a, block_m, route, st);
}
