// One 64x64 output tile of the forward / dX GEMM, as a device function.
//
// The body of gemm.cu's gemm_kernel: it takes its tile (m0, n0) and its
// shared memory as arguments instead of reading blockIdx, so that the
// one-tile-per-CTA kernel (gemm.cu) and the persistent kernels that loop
// over tiles (block_pair.cu, block_one.cu) run the same code and round the
// same way. Epilogues, operands and layouts are documented at the top of
// gemm.cu. Needs 128 threads (four warps of 32x32).
//
// Design: a ring of STAGES k-blocks of A and B (BK = 32 deep) in padded
// shared memory, fed by 16-byte cp.async copies; the copies of k-block
// kb + STAGES - 1 are issued before the products of k-block kb, so at the
// block's shapes (K = 64 to 2048) the next copies are in flight during the
// products, and at K = 64 both k-blocks are in flight at once. The products
// are mma.sync m16n8k16 (bf16 in, float32 accumulators) on ldmatrix
// fragments: at K = 64 the work is bound by bytes, not by the tensor-core
// rate, so the warpgroup wgmma and TMA would buy little here, and mma.sync
// keeps the tile at 32 accumulator registers a thread, which the persistent
// kernels need to stay at 4 CTAs an SM. The tile stays 64 wide in N: the N
// tiles of one M tile run as neighbouring CTAs (gemm.cu's grid), so A comes
// from memory once and from L2 after. A_SCALED scales A's fragments in
// registers after ldmatrix (cp.async copies bytes only): bf16(a·s) per
// element, the rounding the weight gradient applies to dY (gemm.cu). The
// epilogue's arithmetic runs on the accumulator registers; its bf16 results
// are staged in the ring, now idle, and leave in 16-byte row chunks (one
// value at a time where N % 8 != 0). DROP adds dropout (philox.cuh): the
// A operand's mask is applied to each k-block in shared memory once it has
// landed (one Philox block a four values, and a second barrier), the
// output's mask to the accumulators in the epilogue; without it the tile
// compiles to what it was before dropout existed.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace gemm_tile {

constexpr int BM = 64, BN = 64, BK = 32, STAGES = 3, LDS = BK + 8, THREADS = 128;
constexpr int LDC = BN + 8;  // row stride of the staged output tile

struct __align__(128) Smem {
  bf16 A[STAGES][BM][LDS];
  bf16 B[STAGES][BN][LDS];
};
static_assert(sizeof(bf16) * BM * LDC <= sizeof(bf16) * STAGES * BM * LDS,
              "the output tile is staged in the ring's A part (and B's)");

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// d/dh of h·Φ(h): Φ(h) + h·φ(h).
__device__ __forceinline__ float gelu_erf_grad(float h) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  const float pdf = expf(-0.5f * h * h) * 0.3989422804014327f;
  return cdf + h * pdf;
}

// Issue the copies of the k-block at k0 into ring slot `slot`: 64 rows of A
// and 64 of B, four 16-byte chunks each; rows past M or N and chunks past K
// are zero-filled.
__device__ __forceinline__ void load_kblock(const bf16* __restrict__ A,
                                            const bf16* __restrict__ B, int M, int N, int K,
                                            int m0, int n0, int k0, Smem& sm, int slot,
                                            int tid) {
  constexpr int CHUNKS = BK / 8;
  static_assert(BM * CHUNKS % THREADS == 0 && BN * CHUNKS % THREADS == 0, "whole passes");
#pragma unroll
  for (int it = 0; it < BM * CHUNKS / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i / CHUNKS, c = i % CHUNKS * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    cp_async16(&sm.A[slot][r][c], ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok ? 16 : 0);
  }
#pragma unroll
  for (int it = 0; it < BN * CHUNKS / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i / CHUNKS, c = i % CHUNKS * 8;
    const bool ok = n0 + r < N && k0 + c < K;
    cp_async16(&sm.B[slot][r][c], ok ? B + (size_t)(n0 + r) * K + k0 + c : B, ok ? 16 : 0);
  }
}

// Two adjacent values of a bf16 row at p (p + 1 read only if `two`); `vec`:
// p is 4-byte aligned and both exist, one 32-bit access.
__device__ __forceinline__ float2 load2(const bf16* p, bool vec, bool two) {
  if (vec) return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
  return make_float2(bf2f(p[0]), two ? bf2f(p[1]) : 0.f);
}

// Dropout of A's k-block `kb` in ring slot `slot`, in place: each value
// (first scaled by its row's a_scale and rounded, with A_SCALED) becomes
// round(v / kd) where its bit is kept, else 0. K % 4 == 0, so a group of
// four columns is one Philox block.
template <bool A_SCALED>
__device__ __forceinline__ void drop_kblock(unsigned long long key, const DropArgs& drop,
                                            const float* __restrict__ a_scale, int M, int K,
                                            int rows_per_sample, int m0, int k0, Smem& sm,
                                            int slot, int tid) {
  constexpr int QUADS = BK / 4;
#pragma unroll
  for (int it = 0; it < BM * QUADS / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i / QUADS, c = i % QUADS * 4;
    const int gm = m0 + r, gk = k0 + c;
    if (gm >= M || gk >= K) continue;
    const uint32_t bits =
        keep4(key, ((unsigned long long)(drop.row0 + gm) * K + gk) >> 2, drop.thr);
    uint2* p = reinterpret_cast<uint2*>(&sm.A[slot][r][c]);
    const float2 lo = unpack_bf16(p->x), hi = unpack_bf16(p->y);
    float v[4] = {lo.x, lo.y, hi.x, hi.y};
    const float s = A_SCALED ? a_scale[gm / rows_per_sample] : 1.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (A_SCALED) v[e] = round_bf16(v[e] * s);
      v[e] = (bits >> e & 1u) ? v[e] / drop.kd : 0.f;
    }
    *p = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

// EPI is the epilogue (0-3, gemm.cu); A_SCALED scales the rows of A on load
// by a_scale; EXTRA makes epilogue 1 scale the branch by out_scale and
// epilogue 2 write the pre-activation to aux; DROP applies `drop`'s masks.
// The output tile is rows [m0, m0 + BM) and columns [n0, n0 + BN), masked
// at M and N. A caller that runs another tile in the same shared memory
// syncs the CTA first.
template <int EPI, bool A_SCALED, bool EXTRA, bool DROP = false>
__device__ __forceinline__ void tile(
    const bf16* __restrict__ A, const bf16* __restrict__ B,
    const float* __restrict__ bias, const bf16* __restrict__ res,
    bf16* __restrict__ aux, const float* __restrict__ a_scale,
    const float* __restrict__ out_scale, bf16* __restrict__ out, int M, int N,
    int K, int rows_per_sample, int m0, int n0, Smem& sm,
    const DropArgs& drop = DropArgs()) {
  // threadIdx.x through a volatile read: a caller that loops over tiles
  // (block_pair.cu) then recomputes the per-thread offsets in each tile
  // instead of hoisting dozens of them out of its loop, which cost that
  // kernel 3 CTAs per SM instead of 4 in registers. The arithmetic, and so
  // every result, is the same either way.
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32
  const int g = lane >> 2, q4 = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int kblocks = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kblocks) load_kblock(A, B, M, N, K, m0, n0, s * BK, sm, s, tid);
    cp_async_commit();
  }
  // A_SCALED: the scale of each of this thread's A rows (m16 tile i, row g + 8h).
  float sc[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
  if constexpr (A_SCALED) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm * 32 + i * 16 + g + 8 * h;
        sc[i][h] = gm < M ? a_scale[gm / rows_per_sample] : 0.f;
      }
  }

  // DROP: A's mask key, read once (a null key leaves that side alone).
  const bool drop_a = DROP && drop.key_a != nullptr, drop_out = DROP && drop.key_out != nullptr;
  const unsigned long long key_a = drop_a ? *drop.key_a : 0ull;

  for (int kb = 0; kb < kblocks; ++kb) {
    cp_async_wait<STAGES - 2>();  // k-block kb has landed (this thread's copies)
    __syncthreads();              // everyone's, and slot (kb - 1) % STAGES is free
    const int nk = kb + STAGES - 1;
    if (nk < kblocks) load_kblock(A, B, M, N, K, m0, n0, nk * BK, sm, nk % STAGES, tid);
    cp_async_commit();
    const int slot = kb % STAGES;
    if constexpr (DROP) {
      if (drop_a) {  // scaled and masked in place, so the fragments are not scaled again
        drop_kblock<A_SCALED>(key_a, drop, a_scale, M, K, rows_per_sample, m0, kb * BK, sm,
                              slot, tid);
        __syncthreads();
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4(a[i], &sm.A[slot][wm * 32 + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
        if constexpr (A_SCALED) {
          if (!drop_a) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[i][e] = scale_bf16x2(a[i][e], sc[i][e & 1]);
          }
        }
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &sm.B[slot][wn * 32 + jp * 16 + (lane >> 4) * 8 + (lane & 7)]
                        [kk + ((lane >> 3) & 1) * 8]);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the epilogue stages in it

  // The epilogue's values, rounded to bf16, go to a 64 x 64 tile in shared
  // memory (for EPI 2 with EXTRA the pre-activation to a second one), which
  // then leaves in 16-byte row chunks: whole 32-byte sectors, where a warp's
  // stores straight from the fragments would write eight rows' halves.
  // The output's mask key, read here rather than held through the main loop.
  const unsigned long long key_out = drop_out ? *drop.key_out : 0ull;
  bf16 (*Cs)[LDC] = reinterpret_cast<bf16 (*)[LDC]>(&sm.A[0][0][0]);
  bf16 (*Ps)[LDC] = reinterpret_cast<bf16 (*)[LDC]>(&sm.B[0][0][0]);
  const auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool even_n = (N & 1) == 0 && ((bits(res) | bits(aux)) & 3) == 0;  // bf16x2 loads
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + i * 16 + g + 8 * h, gm = m0 + r;
      if (gm >= M) continue;
      float dp = 1.f;
      if constexpr (EPI == 1 && EXTRA) dp = out_scale[gm / rows_per_sample];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + 2 * q4, gn = n0 + c;
        if (gn >= N) continue;
        const bool two = gn + 1 < N, vec = even_n && two;
        const size_t o = (size_t)gm * N + gn;
        float v0 = acc[i][j][2 * h] + (bias != nullptr ? bias[gn] : 0.f);
        float v1 = acc[i][j][2 * h + 1] + (bias != nullptr && two ? bias[gn + 1] : 0.f);
        // DROP: the output's keep bits of (gm, gn) and (gm, gn + 1); N is even.
        uint32_t keep = 3u;
        if constexpr (DROP) {
          if (drop_out)
            keep = keep2(key_out, (unsigned long long)(drop.row0 + gm) * N + gn, drop.thr);
        }
        const auto dropped = [&](float v, int e) {  // round(round(v) / kd), or 0
          return (keep >> e & 1u) ? round_bf16(round_bf16(v) / drop.kd) : 0.f;
        };
        if constexpr (EPI == 1) {
          float b0 = round_bf16(v0), b1 = round_bf16(v1);
          if constexpr (DROP) {
            if (drop_out) {
              b0 = dropped(b0, 0);
              b1 = dropped(b1, 1);
            }
          }
          if constexpr (EXTRA) {
            b0 = round_bf16(b0 * dp);
            b1 = round_bf16(b1 * dp);
          }
          const float2 r2 = load2(res + o, vec, two);
          v0 = r2.x + b0;
          v1 = r2.y + b1;
        } else if constexpr (EPI == 2) {
          if constexpr (EXTRA) *reinterpret_cast<uint32_t*>(&Ps[r][c]) = pack_bf16(v0, v1);
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
          if constexpr (DROP) {
            if (drop_out) {
              v0 = dropped(v0, 0);
              v1 = dropped(v1, 1);
            }
          }
        } else if constexpr (EPI == 3) {
          if constexpr (DROP) {
            if (drop_out) {
              v0 = dropped(v0, 0);
              v1 = dropped(v1, 1);
            }
          }
          const float2 h2 = load2(aux + o, vec, two);
          v0 *= gelu_erf_grad(h2.x);
          v1 *= gelu_erf_grad(h2.y);
        }
        *reinterpret_cast<uint32_t*>(&Cs[r][c]) = pack_bf16(v0, v1);
      }
    }
  __syncthreads();
  constexpr bool PRE = EPI == 2 && EXTRA;
  const bool rows16 = N % 8 == 0 && ((bits(out) | bits(aux)) & 15) == 0;  // 16-byte chunks
#pragma unroll
  for (int it = 0; it < BM * BN / 8 / THREADS; ++it) {
    const int idx = tid + it * THREADS, r = idx / (BN / 8), c = idx % (BN / 8) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const size_t o = (size_t)gm * N + gn;
    if (rows16) {
      *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(&Cs[r][c]);
      if constexpr (PRE)
        *reinterpret_cast<uint4*>(aux + o) = *reinterpret_cast<const uint4*>(&Ps[r][c]);
    } else {
      for (int e = 0; e < 8 && gn + e < N; ++e) {
        out[o + e] = Cs[r][c + e];
        if constexpr (PRE) aux[o + e] = Ps[r][c + e];
      }
    }
  }
}

// The keep bit of element i of a dropout site.
__device__ __forceinline__ bool keep1(unsigned long long key, unsigned long long i,
                                      uint32_t thr) {
  const uint4 w = philox::philox4x32_10(i >> 2, key);
  const uint32_t e = (uint32_t)(i & 3);
  return (e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w) < thr;
}

}  // namespace gemm_tile
