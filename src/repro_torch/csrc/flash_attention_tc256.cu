// fa_tc<256, 256, KSTEPS>: bf16 hd and dv of 200 to 256 (gemma2's 256).
// Compiled apart from the other instantiations so that nvcc builds them
// in parallel; flash_attention.cu dispatches here.
#include "flash_attention.cuh"

extern "C" int repro_fa_tc_256_256(REPRO_FA_PARAMS) {
  return run_tc<256, 256>(REPRO_FA_ARGS);
}
