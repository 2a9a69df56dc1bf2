// fa_tc<64, 64, KSTEPS>: bf16 hd and dv of 8 to 64.
// Compiled apart from the other instantiations so that nvcc builds them
// in parallel; flash_attention.cu dispatches here.
#include "flash_attention.cuh"

extern "C" int repro_fa_tc_64_64(REPRO_FA_PARAMS) {
  return run_tc<64, 64>(REPRO_FA_ARGS);
}
