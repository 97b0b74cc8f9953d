// One row of the forward LayerNorm, as a device function run by one warp.
//
// The body of layernorm.cu's layernorm_kernel: it takes its row and lane as
// arguments instead of reading blockIdx, so that the one-row-per-warp kernel
// (layernorm.cu) and the persistent kernel that loops over rows
// (block_pair.cu) run the same code and round the same way. Float32
// two-pass mean / variance as the reference computes them; bf16 out.
// row_at is the same body on a row's own pointers, for a caller that
// normalises into shared memory (ln_mlp.cu).
#pragma once

#include "common.cuh"

namespace ln_row {

__device__ __forceinline__ void row_at(const bf16* __restrict__ xr,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b,
                                       bf16* __restrict__ yr, int C, float eps,
                                       int lane) {
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

__device__ __forceinline__ void row(const bf16* __restrict__ x,
                                    const float* __restrict__ w,
                                    const float* __restrict__ b, bf16* __restrict__ y,
                                    int row, int C, float eps, int lane) {
  row_at(x + (size_t)row * C, w, b, y + (size_t)row * C, C, eps, lane);
}

}  // namespace ln_row
