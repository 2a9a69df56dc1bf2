// fa_simt<__nv_bfloat16, HD, HDV> at every template width: bf16 prefill on the
// CUDA cores. Compiled apart from the other dtype and the tensor-core
// instantiations so that nvcc builds them in parallel;
// flash_attention.cu dispatches here.
#include "flash_attention.cuh"

extern "C" int repro_fa_simt_bf16(REPRO_FA_PARAMS) {
  return run_simt<__nv_bfloat16>(REPRO_FA_ARGS);
}
