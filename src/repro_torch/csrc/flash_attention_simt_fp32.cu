// fa_simt<float, HD, HDV> at every template width: fp32 prefill on the
// CUDA cores at the pairs fa_tf32 does not take. Compiled apart from the
// other dtype and the tensor-core instantiations so that nvcc builds them
// in parallel; flash_attention.cu dispatches here.
#include "flash_attention.cuh"

extern "C" int repro_fa_simt_fp32(REPRO_FA_PARAMS) {
  return run_simt<float>(REPRO_FA_ARGS);
}
