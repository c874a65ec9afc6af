// Constants and host-side helpers shared by the flash-attention kernels
// (flash_fwd_tc.cu, flash_fwd_dmma.cu, flash_bwd_tc.cu,
// flash_bwd_dkv_3xtf32.cu, flash_bwd_dq_tc.cu): the mask values of the
// module and the tiling and row-alignment tests of the launchers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace t2o {

constexpr float kNegMask = -1e9f;     // NEG_MASK_VALUE of the module
constexpr float kPad = -1e30f;        // running-max start, below every mask

// Host side: do a tensor's rows load and store as aligned groups of 4
// elements (16-byte f32 or 8-byte bf16 vectors)? strides over (B, H, T, D).
inline bool rows_of_4(const void* ptr, const int64_t* s, int dtype) {
  const uintptr_t align = dtype == 0 ? 16 : 8;
  return reinterpret_cast<uintptr_t>(ptr) % align == 0 && s[0] % 4 == 0 &&
         s[1] % 4 == 0 && s[2] % 4 == 0 && s[3] == 1;
}

// Host side: balanced tiles of at most `cap` rows over `n` rows.
inline void balanced_tiles(int n, int cap, int* rows, int* tiles) {
  *tiles = (n + cap - 1) / cap;
  *rows = (n + *tiles - 1) / *tiles;
}

}  // namespace t2o
