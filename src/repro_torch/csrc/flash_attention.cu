// flash_attention: prefill self-attention with an online softmax, for
// Hopper (sm_90a): the C entry and its dispatch.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// launched by flash_attention). The kernels, their design and what bounds
// them are in flash_attention.cuh. They compile apart, one source per
// tensor-core instantiation (flash_attention_tc64.cu, _tc128.cu,
// _tc256.cu, _tc192.cu; fp32's flash_attention_tf32_64.cu, _tf32_128.cu)
// and one for the CUDA-core kernel in each dtype
// (flash_attention_simt_fp32.cu, _simt_bf16.cu), so that the build runs
// them in parallel nvcc processes; this file checks a call and picks the
// entry.
#include "flash_attention.cuh"

// q, k, v and out in one dtype (0 = fp32, 1 = bf16), contiguous; q_pos
// int32 [B, S]. causal: 0 or 1; window <= 0 means no window and chunk <=
// 0 no block-local chunk (a non-causal call must pass neither), softcap
// <= 0 no softcap; 1 <= hd, dv <= 256 (q and k at hd, v and out at dv).
// path: 0 = the tensor cores (bf16, hd and dv multiples of 8 whose widths
// rounded up to 64 are (64, 64), (128, 128), (256, 256) or (192, 128),
// 16-byte aligned q, k, v), 1 = the CUDA cores (either dtype, any hd and
// dv), 2 = the tensor cores in three-pass TF32 (fp32, hd and dv multiples
// of 4 whose widths rounded up to 64 are (64, 64) or (128, 128)), as
// kernels/flash_attention.py::path chooses (its TC_HEAD_DIMS and
// TF32_HEAD_DIMS are the pairs below). Returns the first CUDA error of the launch, or
// cudaErrorInvalidValue for a call the kernel does not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, const void* q_pos,
                                     void* out, int B, int S, int H, int KV,
                                     int hd, int dv, float scale, int causal,
                                     int window, int chunk, float softcap,
                                     int dtype, int path, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      hd <= 0 || hd > 256 || dv <= 0 || dv > 256 || dtype < 0 || dtype > 1 ||
      (!causal && (window > 0 || chunk > 0))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == PATH_TC) {
    if (dtype != 1 || hd % 8 != 0 || dv % 8 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    const int w_hd = (hd + 63) / 64 * 64, w_dv = (dv + 63) / 64 * 64;
    if (w_hd == 64 && w_dv == 64) {
      return repro_fa_tc_64_64(q, k, v, q_pos, out, B, S, H, KV, hd, dv,
                               scale, causal, window, chunk, softcap, st);
    }
    if (w_hd == 128 && w_dv == 128) {
      return repro_fa_tc_128_128(q, k, v, q_pos, out, B, S, H, KV, hd, dv,
                                 scale, causal, window, chunk, softcap, st);
    }
    if (w_hd == 256 && w_dv == 256) {
      return repro_fa_tc_256_256(q, k, v, q_pos, out, B, S, H, KV, hd, dv,
                                 scale, causal, window, chunk, softcap, st);
    }
    if (w_hd == 192 && w_dv == 128) {
      return repro_fa_tc_192_128(q, k, v, q_pos, out, B, S, H, KV, hd, dv,
                                 scale, causal, window, chunk, softcap, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (path == PATH_TF32) {
    if (dtype != 0 || hd % 4 != 0 || dv % 4 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    const int w_hd = (hd + 63) / 64 * 64, w_dv = (dv + 63) / 64 * 64;
    if (w_hd == 64 && w_dv == 64) {
      return repro_fa_tf32_64_64(q, k, v, q_pos, out, B, S, H, KV, hd, dv,
                                 scale, causal, window, chunk, softcap, st);
    }
    if (w_hd == 128 && w_dv == 128) {
      return repro_fa_tf32_128_128(q, k, v, q_pos, out, B, S, H, KV, hd, dv,
                                   scale, causal, window, chunk, softcap,
                                   st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (path != PATH_SIMT) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    return repro_fa_simt_bf16(q, k, v, q_pos, out, B, S, H, KV, hd, dv,
                              scale, causal, window, chunk, softcap, st);
  }
  return repro_fa_simt_fp32(q, k, v, q_pos, out, B, S, H, KV, hd, dv, scale,
                            causal, window, chunk, softcap, st);
}
