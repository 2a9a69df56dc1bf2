// fa_tf32<64, 64>: fp32 hd and dv of 4 to 64, multiples of 4 (the
// reduced configs' 64), three-pass TF32 on the tensor cores.
// Compiled apart from the other instantiations so that nvcc builds them
// in parallel; flash_attention.cu dispatches here.
#include "flash_attention.cuh"

extern "C" int repro_fa_tf32_64_64(REPRO_FA_PARAMS) {
  return run_tf32<64, 64>(REPRO_FA_ARGS);
}
