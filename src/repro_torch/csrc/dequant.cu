// dequant: out[r, c] = float(v[r, c]) * s[c], cast to fp32 or bf16, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dequant.py (_dequant_kernel,
// launched by dequant_int8), which the eager quantized swap-in runs on every
// quantized leaf. For int4 the JAX package first unpacks the carrier in a
// separate pass (ref.unpack_int4_ref); here bits = 4 reads carrier row
// r / 2 and takes the nibble by the parity of r, so the unpack and the
// multiply are one pass over the carrier.
//
// What bounds it on an H100: bytes. It reads one byte (half a byte at
// int4) and writes 4 (fp32) or 2 (bf16) per element, with one multiply in
// between. Design: a grid-stride loop over rows, the threads of a block
// striding over the columns of a row, so neighbouring threads touch
// neighbouring bytes and no thread divides a flat index. Vector loads and
// stores are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 132 * 64;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename OutT, int BITS>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const int8_t* __restrict__ v, const float* __restrict__ s,
               OutT* __restrict__ out, int64_t R, int64_t C) {
  for (int64_t r = blockIdx.x; r < R; r += gridDim.x) {
    const int8_t* row = v + (BITS == 4 ? (r >> 1) : r) * C;
    OutT* orow = out + r * C;
    for (int64_t c = threadIdx.x; c < C; c += THREADS) {
      const int8_t b = row[c];
      int q;
      if (BITS == 4) {
        q = (r & 1) ? (b >> 4) : ((int8_t)((uint8_t)b << 4) >> 4);
      } else {
        q = b;
      }
      orow[c] = from_f<OutT>((float)q * s[c]);
    }
  }
}

template <typename OutT>
void launch(const void* values, const void* scales, void* out, int64_t R,
            int64_t C, int bits, cudaStream_t stream) {
  const int64_t blocks = R < MAX_BLOCKS ? R : MAX_BLOCKS;
  const int8_t* vp = static_cast<const int8_t*>(values);
  const float* sp = static_cast<const float*>(scales);
  OutT* op = static_cast<OutT*>(out);
  if (bits == 4) {
    dequant_kernel<OutT, 4><<<(unsigned)blocks, THREADS, 0, stream>>>(vp, sp, op, R, C);
  } else {
    dequant_kernel<OutT, 8><<<(unsigned)blocks, THREADS, 0, stream>>>(vp, sp, op, R, C);
  }
}

}  // namespace

// values: int8 [R, C] (bits 8) or the int4 carrier [ceil(R/2), C] (bits 4);
// R is the LOGICAL row count. out_dtype: 0 = fp32, 1 = bf16. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_dequant(const void* values, const void* scales, void* out,
                             int64_t R, int64_t C, int bits, int out_dtype,
                             void* stream) {
  if (R <= 0 || C <= 0 || (bits != 8 && bits != 4) || out_dtype < 0 ||
      out_dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) {
    launch<__nv_bfloat16>(values, scales, out, R, C, bits, st);
  } else {
    launch<float>(values, scales, out, R, C, bits, st);
  }
  return (int)cudaGetLastError();
}

// Message for a code returned by the entries of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
