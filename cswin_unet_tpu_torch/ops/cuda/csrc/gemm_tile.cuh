// One 64x64 output tile of the forward / dX GEMM, as a device function.
//
// The body of gemm.cu's gemm_kernel: it takes its tile (m0, n0) and its
// shared memory as arguments instead of reading blockIdx, so that the
// one-tile-per-CTA kernel (gemm.cu) and the persistent kernel that loops
// over tiles (block_pair.cu) run the same code and round the same way.
// Epilogues, operands and layouts are documented at the top of gemm.cu.
// Needs 128 threads (four warps of 32x32).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace gemm_tile {

constexpr int BM = 64, BN = 64, BK = 32, PAD = 8, CPAD = 4, THREADS = 128;

struct __align__(128) Smem {
  bf16 As[BM][BK + PAD];
  bf16 Bs[BN][BK + PAD];
  float Cs[BM][BN + CPAD];
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// d/dh of h·Φ(h): Φ(h) + h·φ(h).
__device__ __forceinline__ float gelu_erf_grad(float h) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  const float pdf = expf(-0.5f * h * h) * 0.3989422804014327f;
  return cdf + h * pdf;
}

// Eight bf16 values from a 16-byte chunk, each scaled by s and rounded back.
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int t = 0; t < 8; ++t) e[t] = f2bf(bf2f(e[t]) * s);
  return v;
}

// EPI is the epilogue (0-3, gemm.cu); A_SCALED scales the rows of A on load
// by a_scale; EXTRA makes epilogue 1 scale the branch by out_scale and
// epilogue 2 write the pre-activation to aux. The output tile is rows
// [m0, m0 + BM) and columns [n0, n0 + BN), masked at M and N.
template <int EPI, bool A_SCALED, bool EXTRA>
__device__ __forceinline__ void tile(
    const bf16* __restrict__ A, const bf16* __restrict__ B,
    const float* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ aux, const float* __restrict__ a_scale,
    const float* __restrict__ out_scale, bf16* __restrict__ out, int M, int N,
    int K, int rows_per_sample, int m0, int n0, Smem& sm) {
  using namespace nvcuda;
  // threadIdx.x through a volatile read: a caller that loops over tiles
  // (block_pair.cu) then recomputes the per-thread offsets in each tile
  // instead of hoisting dozens of them out of its loop, which cost that
  // kernel 3 CTAs per SM instead of 4 in registers. The arithmetic, and so
  // every result, is the same either way.
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  constexpr int CHUNKS = BK / 8;  // 16-byte chunks per tile row
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int gm = m0 + r, gk = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K) {
        v = *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk);
        if constexpr (A_SCALED) v = scale8(v, a_scale[gm / rows_per_sample]);
      }
      *reinterpret_cast<uint4*>(&sm.As[r][c]) = v;
    }
    for (int i = tid; i < BN * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int gn = n0 + r, gk = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < N && gk < K) v = *reinterpret_cast<const uint4*>(B + (size_t)gn * K + gk);
      *reinterpret_cast<uint4*>(&sm.Bs[r][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sm.As[wm * 32 + i * 16][kk], BK + PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &sm.Bs[wn * 32 + j * 16][kk], BK + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sm.Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j],
                              BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float v = sm.Cs[r][c] + (bias != nullptr ? bias[gn] : 0.f);
    const size_t o = (size_t)gm * N + gn;
    if constexpr (EPI == 1) {
      float branch = round_bf16(v);
      if constexpr (EXTRA) branch = round_bf16(branch * out_scale[gm / rows_per_sample]);
      v = bf2f(res[o]) + branch;
    } else if constexpr (EPI == 2) {
      if constexpr (EXTRA) aux[o] = f2bf(v);
      v = gelu_erf(v);
    } else if constexpr (EPI == 3) {
      v *= gelu_erf_grad(bf2f(aux[o]));
    }
    out[o] = f2bf(v);
  }
}

}  // namespace gemm_tile
