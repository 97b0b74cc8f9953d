// One float32 output tile of the forward / dX GEMM (TPU.COMPUTE_DTYPE
// float32), as a device function: the body of gemm_f32.cu's
// gemm_f32_kernel, which takes its tile (m0, n0) and its shared memory as
// arguments instead of reading blockIdx, so that the one-tile-per-CTA
// kernel (gemm_f32.cu) and the persistent float32 pair (block_phases.cuh)
// run the same code and round the same way. Operands, epilogues, the
// operand scale and dropout are documented at the top of gemm_f32.cu. A
// caller that runs another tile in the same shared memory syncs the CTA
// first (the epilogue reads the staged outputs).
//
// Design: a BM x BN output tile a CTA,
//   8 x TN outputs a thread: thread (tx, ty) = (tid % (BN/TN), tid / (BN/TN))
//   owns rows ty + (BM/8)·i and columns tx + (BN/TN)·j. A ring of STAGES
//   k-blocks BK = 32 deep of A and B, both k-major as in memory, rows padded
//   to 36 floats, fed by 16-byte cp.async copies (two k-blocks in flight
//   during the products, a barrier every 32 k). Every 4 k a thread reads TN
//   16-byte words of B (a quarter-warp's eight consecutive rows fall in
//   distinct banks) and, one row at a time, one word of A (a quarter-warp's
//   broadcast) for 4·TN FFMAs. At the block's shapes the grid, not the
//   shared loads, sets the pace: tiny-224's stage 3 at bs 24 has 1.2 M
//   outputs, 4.5 warps an SM at 8 x 8 outputs a thread, so the planner's
//   tiles (kernels.gemm_f32_plan) are 64 x 64 at 8 x 4 (128 threads, 96
//   registers, four CTAs an SM) and 128 x 32 at 8 x 4 where N's 32-column
//   tiles waste fewer columns; 8 x 8 tiles of 128 x 64 and 128 x 128 were
//   slower at every training shape of tiny-224 and most of base-384's (the
//   sweep in PERF.md). Each output is one fmaf chain over k from 0 in
//   order and the epilogue's operations run in one order, so every tile
//   shape gives the same bits (the persistent float32 pair runs this tile
//   too and equals two chains bit for bit). The dX product (KN) reads the weight as stored,
//   (N, K) of the layer, k-blocks of its rows, each thread's four columns
//   one 16-byte word: no transposed copy a call. A_SCALED and A's dropout
//   mask scale and mask A's
//   k-block in shared memory once it has landed (the products are then
//   plain). The accumulators are staged in the idle ring and the epilogue
//   runs on 16-byte row words: bias, residual, pre-activation and output
//   move as float4s, one Philox block masks four outputs.
#pragma once

#include "gemm_tile.cuh"

namespace gemm_f32 {

// k-blocks in the ring (two in flight during the products), their depth, and
// the outputs a thread along N (8 x TN)
constexpr int STAGES = 3, BK = 32, TN = 4;

// A BM x BN tile of threads of 8 x TN outputs: (BN/TN) x (BM/8) threads; ring
// rows of A padded to BK + 4 floats (8 consecutive rows' 16-byte words in
// distinct banks); B's ring as A's, BN rows of k, or with KN (B given as
// (K, N), the weight as stored for the dX product) BK rows of BN outputs
// padded by 4; the staged output rows at a stride of BN + BN/TN floats, so
// that a warp's stores of one accumulator fall in distinct banks.
template <int BM, int BN, bool KN>
struct Shape {
  static constexpr int TX = BN / TN, TY = BM / 8, THREADS = TX * TY, LDS = BK + 4,
                       LDC = BN + TX, BR = KN ? BK : BN, BC = KN ? BN + 4 : LDS;
};

template <int BM, int BN, bool KN>
struct __align__(128) Smem {
  using S = Shape<BM, BN, KN>;
  union {
    struct {
      float A[STAGES][BM][S::LDS];
      float B[STAGES][S::BR][S::BC];
    } ring;
    float C[BM][S::LDC];  // the accumulators, once the ring is idle
  };
  float sc[BM];  // A_SCALED: each tile row's scale
};

template <int BM, int BN, bool KN, int EPI, bool EXTRA, bool A_SCALED, bool DROP>
__device__ __forceinline__ void tile(const float* __restrict__ A, const float* __restrict__ B,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ res, float* __restrict__ aux,
                                     const float* __restrict__ a_scale,
                                     const float* __restrict__ out_scale,
                                     float* __restrict__ out, int M, int N, int K,
                                     int rows_per_sample, int m0, int n0, const DropArgs& drop,
                                     Smem<BM, BN, KN>& sm) {
  using S = Shape<BM, BN, KN>;
  constexpr int NT = S::THREADS, TX = S::TX, TY = S::TY;
  static_assert(EPI >= 0 && EPI <= 3, "epilogues 0-3");
  static_assert(TN == 4, "a thread's KN columns are one 16-byte word");
  auto& ring = sm.ring;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  // The tile column of this thread's output j: strided, or with KN
  // consecutive (one 16-byte word of B's rows).
  const auto col = [&](int j) { return KN ? TN * tx + j : tx + TX * j; };

  // The copies of k-block kb into ring slot `slot`: 16-byte chunks, rows past
  // M or N and chunks past K (with KN: past K or N) zero-filled.
  const auto load = [&](int kb, int slot) {
    constexpr int CH = BK / 4, CB = BN / 4;
    static_assert(BM * CH % NT == 0 && (KN ? BK * CB : BN * CH) % NT == 0, "whole passes");
    const int k0 = kb * BK;
#pragma unroll
    for (int it = 0; it < BM * CH / NT; ++it) {
      const int i = tid + it * NT, r = i / CH, c = i % CH * 4;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(&ring.A[slot][r][c], ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok ? 16 : 0);
    }
    if constexpr (KN) {
#pragma unroll
      for (int it = 0; it < BK * CB / NT; ++it) {
        const int i = tid + it * NT, r = i / CB, c = i % CB * 4;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(&ring.B[slot][r][c], ok ? B + (size_t)(k0 + r) * N + n0 + c : B,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int it = 0; it < BN * CH / NT; ++it) {
        const int i = tid + it * NT, r = i / CH, c = i % CH * 4;
        const bool ok = n0 + r < N && k0 + c < K;
        cp_async16(&ring.B[slot][r][c], ok ? B + (size_t)(n0 + r) * K + k0 + c : B,
                   ok ? 16 : 0);
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int kblocks = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kblocks) load(s, s);
    cp_async_commit();
  }
  if constexpr (A_SCALED) {  // read by the first k-block's pass, after its barrier
    for (int r = tid; r < BM; r += NT)
      sm.sc[r] = m0 + r < M ? a_scale[(m0 + r) / rows_per_sample] : 1.f;
  }
  const bool drop_a = DROP && drop.key_a != nullptr, drop_out = DROP && drop.key_out != nullptr;
  const unsigned long long key_a = drop_a ? *drop.key_a : 0ull;

  for (int kb = 0; kb < kblocks; ++kb) {
    cp_async_wait<STAGES - 2>();  // k-block kb has landed (this thread's copies)
    __syncthreads();              // everyone's, and slot (kb - 1) % STAGES is free
    const int nk = kb + STAGES - 1;
    if (nk < kblocks) load(nk, nk % STAGES);
    cp_async_commit();
    const int slot = kb % STAGES;
    if (A_SCALED || drop_a) {
      // A' in place: each value times its row's scale, then v / kd where
      // kept, else 0 (one Philox block a four columns; K % 4 == 0): the
      // same arithmetic on each value at every tile shape.
      constexpr int QUADS = BK / 4;
      for (int i = tid; i < BM * QUADS; i += NT) {
        const int r = i / QUADS, c = i % QUADS * 4, gm = m0 + r, gk = kb * BK + c;
        if (gm >= M || gk >= K) continue;
        float4* p = reinterpret_cast<float4*>(&ring.A[slot][r][c]);
        float v[4] = {p->x, p->y, p->z, p->w};
        uint32_t bits = 0xFu;
        if constexpr (DROP) {
          if (drop_a) bits = keep4(key_a, ((unsigned long long)(drop.row0 + gm) * K + gk) >> 2,
                                   drop.thr);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (A_SCALED) v[e] *= sm.sc[r];
          if constexpr (DROP) {
            if (drop_a) v[e] = (bits >> e & 1u) ? v[e] / drop.kd : 0.f;
          }
        }
        *p = make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float b[4][TN];  // B at k = kk + e, this thread's column j
      if constexpr (KN) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 t = *reinterpret_cast<const float4*>(&ring.B[slot][kk + e][TN * tx]);
          b[e][0] = t.x, b[e][1] = t.y, b[e][2] = t.z, b[e][3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 t = *reinterpret_cast<const float4*>(&ring.B[slot][tx + TX * j][kk]);
          b[0][j] = t.x, b[1][j] = t.y, b[2][j] = t.z, b[3][j] = t.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(&ring.A[slot][ty + TY * i][kk]);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float t = acc[i][j];
          t = fmaf(a.x, b[0][j], t);
          t = fmaf(a.y, b[1][j], t);
          t = fmaf(a.z, b[2][j], t);
          t = fmaf(a.w, b[3][j], t);
          acc[i][j] = t;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the accumulators go there

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (KN) {  // the four columns are one 16-byte word
      *reinterpret_cast<float4*>(&sm.C[ty + TY * i][col(0)]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) sm.C[ty + TY * i][col(j)] = acc[i][j];
    }
  }
  __syncthreads();

  // The epilogue on four consecutive outputs of a row at a time: 16-byte
  // loads and stores where N % 4 == 0 and the rows are aligned, else one
  // value at a time; each value's operations in one order.
  const unsigned long long key_out = drop_out ? *drop.key_out : 0ull;
  const auto bits = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = N % 4 == 0 && ((bits(out) | bits(res) | bits(aux)) & 15) == 0;
  constexpr int QN = BN / 4;
  for (int idx = tid; idx < BM * QN; idx += NT) {
    const int r = idx / QN, c = idx % QN * 4, gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const int ne = vec ? 4 : min(4, N - gn);
    const size_t o = (size_t)gm * N + gn;
    const float4 a4 = *reinterpret_cast<const float4*>(&sm.C[r][c]);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    float rv[4] = {0.f, 0.f, 0.f, 0.f};  // res (epilogue 1) or h (epilogue 3)
    if constexpr (EPI == 1 || EPI == 3) {
      const float* src = EPI == 1 ? res : aux;
      if (vec) {
        const float4 t = *reinterpret_cast<const float4*>(src + o);
        rv[0] = t.x, rv[1] = t.y, rv[2] = t.z, rv[3] = t.w;
      } else {
        for (int e = 0; e < ne; ++e) rv[e] = src[o + e];
      }
    }
    float dp = 1.f;
    if constexpr (EPI == 1 && EXTRA) dp = out_scale[gm / rows_per_sample];
    uint32_t keep = 0xFu;
    if constexpr (DROP) {
      if (drop_out) {
        const unsigned long long i0 = (unsigned long long)(drop.row0 + gm) * N + gn;
        if (vec) {
          keep = keep4(key_out, i0 >> 2, drop.thr);
        } else {
          keep = 0u;
          for (int e = 0; e < ne; ++e) keep |= (uint32_t)gemm_tile::keep1(key_out, i0 + e, drop.thr) << e;
        }
      }
    }
    float y[4], pre[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = av[e] + (bias != nullptr && e < ne ? bias[gn + e] : 0.f);
      const auto dropped = [&](float x) { return (keep >> e & 1u) ? x / drop.kd : 0.f; };
      if constexpr (EPI == 1) {
        if constexpr (DROP) {
          if (drop_out) v = dropped(v);
        }
        if constexpr (EXTRA) v *= dp;
        v = rv[e] + v;
      } else if constexpr (EPI == 2) {
        pre[e] = v;
        v = gemm_tile::gelu_erf(v);
        if constexpr (DROP) {
          if (drop_out) v = dropped(v);
        }
      } else if constexpr (EPI == 3) {
        if constexpr (DROP) {
          if (drop_out) v = dropped(v);
        }
        v *= gemm_tile::gelu_erf_grad(rv[e]);
      }
      y[e] = v;
    }
    constexpr bool PRE = EPI == 2 && EXTRA;
    if (vec) {
      *reinterpret_cast<float4*>(out + o) = make_float4(y[0], y[1], y[2], y[3]);
      if constexpr (PRE)
        *reinterpret_cast<float4*>(aux + o) = make_float4(pre[0], pre[1], pre[2], pre[3]);
    } else {
      for (int e = 0; e < ne; ++e) {
        out[o + e] = y[e];
        if constexpr (PRE) aux[o + e] = pre[e];
      }
    }
  }
}



}  // namespace gemm_f32
