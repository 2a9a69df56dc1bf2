// fa_tc<192, 128, KSTEPS>: bf16 q / k of 136 to 192, v of 72 to 128
// (MLA's 192 / 128).
// Compiled apart from the other instantiations so that nvcc builds them
// in parallel; flash_attention.cu dispatches here.
#include "flash_attention.cuh"

extern "C" int repro_fa_tc_192_128(REPRO_FA_PARAMS) {
  return run_tc<192, 128>(REPRO_FA_ARGS);
}
