// The soft-capped instantiations of flash_attention_bwd_f32.cu's kernels
// (kCap = true) and their launches, repro_fa_bwd_f32_capped, which that
// file's C entries call for softcap > 0.  A source of their own so that
// nvcc builds them beside the uncapped kernels, in parallel.
#define REPRO_FA_CAPPED
#include "flash_attention_bwd_f32.cu"
