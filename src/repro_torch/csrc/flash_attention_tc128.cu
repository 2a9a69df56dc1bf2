// fa_tc<128, 128, KSTEPS>: bf16 hd and dv of 72 to 128 (hubert's 80,
// zamba2's 112, h2o-danube's 120).
// Compiled apart from the other instantiations so that nvcc builds them
// in parallel; flash_attention.cu dispatches here.
#include "flash_attention.cuh"

extern "C" int repro_fa_tc_128_128(REPRO_FA_PARAMS) {
  return run_tc<128, 128>(REPRO_FA_ARGS);
}
