// One row of the forward LayerNorm, as a device function run by one warp.
//
// The body of layernorm.cu's layernorm_kernel: it takes its row and lane as
// arguments instead of reading blockIdx, so that the one-row-per-warp kernel
// (layernorm.cu) and the persistent kernel that loops over rows
// (block_pair.cu) run the same code and round the same way. Float32
// two-pass mean / variance as the reference computes them; bf16 out.
#pragma once

#include "common.cuh"

namespace ln_row {

__device__ __forceinline__ void row(const bf16* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b, bf16* __restrict__ y,
                                    int row, int C, float eps, int lane) {
  const bf16* xr = x + (size_t)row * C;
  bf16* yr = y + (size_t)row * C;

  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += bf2f(xr[c]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = bf2f(xr[c]) - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / C + eps);
  for (int c = lane; c < C; c += 32)
    yr[c] = f2bf((bf2f(xr[c]) - mu) * rstd * w[c] + b[c]);
}

}  // namespace ln_row
