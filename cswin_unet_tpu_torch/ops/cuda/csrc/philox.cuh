// Dropout masks of the block's GEMMs: Philox-4x32-10 (Salmon et al., SC'11)
// of one 64-bit key per site and the element's global index, the bits of
// ops/dropout.py::keep_mask. Element i = (row0 + row) · cols + col of a
// site is kept when word i % 4 of the block at counter (i / 4, 0, 0, 0)
// is below `thr`; a kept value is divided by `kd` (1 − rate in bf16) and
// rounded, a dropped one is 0.
#pragma once

#include <cstdint>

namespace philox {

__device__ __forceinline__ uint4 philox4x32_10(unsigned long long ctr, unsigned long long key) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

}  // namespace philox

// One GEMM's dropout sites. `key_out` masks the output (M, N) in the
// epilogue; `key_a` masks the A operand (M, K) as it lands in shared
// memory (the dX product's dY). Either may be null. The keys are read from
// device memory, where the caller's generator drew them.
struct DropArgs {
  const unsigned long long* key_a = nullptr;
  const unsigned long long* key_out = nullptr;
  long long row0 = 0;  // the global index of row 0 (a rank's offset)
  float kd = 1.f;      // the divisor of a kept value
  uint32_t thr = 0u;   // keep iff the Philox word < thr
};

// Keep bits of elements i and i + 1 of a site (i even, so one Philox
// block holds both): bit 0 for i, bit 1 for i + 1.
__device__ __forceinline__ uint32_t keep2(unsigned long long key, unsigned long long i,
                                          uint32_t thr) {
  const uint4 w = philox::philox4x32_10(i >> 2, key);
  const bool hi = (i & 2) != 0;
  return (uint32_t)((hi ? w.z : w.x) < thr) | ((uint32_t)((hi ? w.w : w.y) < thr) << 1);
}

// Keep bits of the four elements 4q .. 4q + 3: bit e for 4q + e.
__device__ __forceinline__ uint32_t keep4(unsigned long long key, unsigned long long q,
                                          uint32_t thr) {
  const uint4 w = philox::philox4x32_10(q, key);
  return (uint32_t)(w.x < thr) | ((uint32_t)(w.y < thr) << 1) | ((uint32_t)(w.z < thr) << 2) |
         ((uint32_t)(w.w < thr) << 3);
}
