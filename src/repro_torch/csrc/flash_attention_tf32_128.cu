// fa_tf32<128, 128>: fp32 hd and dv of 68 to 128, multiples of 4 (qwen's
// and granite-20b's 128, h2o-danube's 120, zamba2's 112), three-pass TF32
// on the tensor cores.
// Compiled apart from the other instantiations so that nvcc builds them
// in parallel; flash_attention.cu dispatches here.
#include "flash_attention.cuh"

extern "C" int repro_fa_tf32_128_128(REPRO_FA_PARAMS) {
  return run_tf32<128, 128>(REPRO_FA_ARGS);
}
