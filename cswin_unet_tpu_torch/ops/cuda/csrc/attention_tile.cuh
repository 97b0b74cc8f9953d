// One (window, head) of CSWin stripe attention + LePE, as a device function.
//
// The body of stripe_attention.cu's stripe_attention_kernel: it takes its
// window, head and shared memory as arguments instead of reading blockIdx,
// so that the one-tile-per-CTA kernel (stripe_attention.cu) and the
// persistent kernels that loop over tiles (block_pair.cu, block_one.cu) run
// the same code and round the same way. The function, the two epilogue
// roundings and the layouts are documented at the top of stripe_attention.cu.
// Needs WARPS warps and smem_bytes<D>(L) bytes of shared memory.
//
// Design (tensor cores; the roundings of the function, not of its sums):
//   * staging: q, k and v of the (window, head) land in shared memory as
//     bf16 through 16-byte cp.async copies (a pixel's head slice is D·2
//     contiguous bytes), rows padded to row_stride<D>() so that ldmatrix
//     reads them without bank conflicts; L is padded to a multiple of 16
//     with zero rows, D = 24 to a depth of 32 with zero columns. The LePE
//     taps and bias of the head are staged once as float32.
//   * each warp owns 16-query slabs. S = Q·Kᵀ with mma.sync m16n8k16 (bf16
//     in, float32 out), Q's fragments scaled and rounded to bf16 in
//     registers (q·scale is rounded before the product, as the reference
//     rounds it); keys past L are masked to -inf before the max.
//   * the softmax runs on the accumulator fragments: a row lives in one quad
//     of lanes, so its max and sum take two shuffles each, and P =
//     bf16(exp(s - max) / sum) is formed in registers and repacked as the A
//     fragments of O = P·V (V through ldmatrix.trans): P never goes through
//     shared memory.
//   * a warp holds KT n8-tiles of scores: 112 keys in the one-tile kernels,
//     64 in the persistent ones (block_phases.cuh), whose other phases leave
//     fewer registers. Longer windows take three passes over key blocks: the
//     max, then the sum, then P and P·V, each recomputing its block's
//     scores, so P is the same rounding of the same softmax (an online
//     rescale would round a different P). Every lane adds its scores' terms
//     in key order whatever KT is, and padded keys add exact zeros, so the
//     result does not depend on KT: the pair equals the chain bit for bit.
//   * LePE runs in the accumulator layout from the bf16 V already in shared
//     memory, and each lane stores its two adjacent output channels as one
//     bf16x2.
//
// MODE cuts the body down at compile time, for pricing its parts alone
// (window_attention in stripe_attention.cu); FULL is the body as the block
// runs it, and the other modes change nothing in it:
//   NO_LEPE     softmax(q·scale · kᵀ) · v, one rounding of the output
//   NO_SOFTMAX  both products with the softmax stubbed, P = bf16(s · 1e-4)
//               (wrong math, the same shapes), no LePE
//   COPY        out = bf16(bf16(q + k) + v): the tile's memory traffic alone
//               (its own body, copy_tile: no shared memory, no arithmetic)
//   SOFTMAX     the first product and the softmax alone: the row of P folded
//               to the head's width, out[i, dd] = bf16(sum of P[i, j] over
//               j = dd, dd + D, ...), no second product
//   STAGE       the staging alone: q, k, v laid out in shared memory as the
//               products want them, then out = bf16(k + v) read back from there
// and the block's attention forms with one part switched off (block_one.cu),
// where the form of P and the LePE switch are orthogonal:
//   SCALE          P = bf16(s · (1/L)) in place of the softmax, LePE as FULL
//   SCALE_NO_LEPE  the same without LePE, one rounding of the output
//   VALUE          no attention: out = v + LePE, rounded as FULL (q and k
//                  are not staged)
#pragma once

#include "common.cuh"

namespace attn_tile {

constexpr int WARPS = 4;
constexpr int KT_MAX = 14;  // n8 key tiles of scores a warp holds: 112 keys, L <= 98 in one pass

enum Mode {
  FULL = 0, NO_LEPE = 1, NO_SOFTMAX = 2, COPY = 3, SOFTMAX = 4, STAGE = 5,
  SCALE = 6, SCALE_NO_LEPE = 7, VALUE = 8
};

// Whether a mode adds LePE to its output, and whether it runs the products.
__host__ __device__ constexpr bool with_lepe(int mode) {
  return mode == FULL || mode == SCALE || mode == VALUE;
}
__host__ __device__ constexpr bool attends(int mode) {
  return mode != VALUE;
}
__host__ __device__ constexpr bool softmaxed(int mode) {
  return mode == FULL || mode == NO_LEPE || mode == SOFTMAX;
}

// Row stride of the staged q, k, v in bf16 elements: the head dim padded to
// the products' depth (a multiple of 16) plus 8, so that the eight 16-byte
// rows of an ldmatrix fall in distinct banks.
template <int D>
__host__ __device__ constexpr int row_stride() {
  return (D + 15) / 16 * 16 + 8;
}

__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <int D>
constexpr size_t smem_bytes(int L) {
  return (size_t)3 * ((L + 15) / 16 * 16) * row_stride<D>() * sizeof(bf16) +
         (size_t)10 * D * sizeof(float);
}

// q, k, v point at channel 0 of the branch; pixel p of each starts at
// p * in_ps, of the output at p * out_ps (the pointers and in_ps·2 must be
// 16-byte aligned: the wrappers check). TW: type of the LePE taps (9, cb)
// and bias (cb,), unread by the modes without LePE. PALLAS: the epilogue's
// rounding where LePE is added. win walks the batch's windows (image-major,
// then window rows, then window columns). KT: n8 key tiles of scores held in
// registers (even; the result does not depend on it).
template <int D, typename TW, bool PALLAS, int MODE = FULL, int KT = KT_MAX>
__device__ __forceinline__ void tile(const bf16* __restrict__ qp,
                                     const bf16* __restrict__ kp,
                                     const bf16* __restrict__ vp, size_t in_ps,
                                     const TW* __restrict__ lepe_w,
                                     const TW* __restrict__ lepe_b,
                                     bf16* __restrict__ out, size_t out_ps, int H, int W,
                                     int cb, int h_sp, int w_sp, float scale, int win,
                                     int head, float* smem) {
  static_assert(D % 8 == 0 && D <= 32, "head dims 16, 24, 32");
  static_assert(KT % 2 == 0, "P·V takes the scores in pairs of n8 tiles");
  constexpr int DP = row_stride<D>();
  constexpr int DK = (D + 15) / 16;  // k16 steps of Q·Kᵀ
  constexpr int DZ = DK * 16;        // the depth they read, zero past D
  constexpr int DN = D / 8;          // n8 tiles of P·V
  constexpr int CH = D / 8;          // 16-byte chunks of a pixel's head slice
  const int L = h_sp * w_sp, LP = (L + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + LP * DP;
  bf16* Vs = Ks + LP * DP;
  float* Tw = reinterpret_cast<float*>(Vs + LP * DP);  // 9 taps, then the bias; D each

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * h_sp, col0 = win % n_ww * w_sp;
  const int hc = head * D;  // branch-local channel of this head
  const auto pixel = [&](int t) {
    return ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
  };

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH * 8;
    const size_t p = pixel(t) * in_ps + hc + c;
    if constexpr (attends(MODE)) {
      cp_async16(Qs + t * DP + c, qp + p);
      cp_async16(Ks + t * DP + c, kp + p);
    }
    cp_async16(Vs + t * DP + c, vp + p);
  }
  cp_async_commit();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < (LP - L) * (DZ / 8); i += blockDim.x) {
    const int off = (L + i / (DZ / 8)) * DP + i % (DZ / 8) * 8;
    *reinterpret_cast<uint4*>(Qs + off) = zero;
    *reinterpret_cast<uint4*>(Ks + off) = zero;
    *reinterpret_cast<uint4*>(Vs + off) = zero;
  }
  if constexpr (DZ > D) {
    static_assert(DZ - D == 8, "one zero chunk per row");
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      *reinterpret_cast<uint4*>(Qs + t * DP + D) = zero;
      *reinterpret_cast<uint4*>(Ks + t * DP + D) = zero;
    }
  }
  if constexpr (with_lepe(MODE)) {
    for (int i = threadIdx.x; i < 10 * D; i += blockDim.x) {
      const int tap = i / D, dd = i % D;
      Tw[i] = tap < 9 ? to_f(lepe_w[tap * cb + hc + dd]) : to_f(lepe_b[hc + dd]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if constexpr (MODE == STAGE) {
    for (int i = threadIdx.x; i < L * (D / 2); i += blockDim.x) {
      const int t = i / (D / 2), dd = i % (D / 2) * 2;
      const float2 k2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(Ks + t * DP + dd));
      const float2 v2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(Vs + t * DP + dd));
      *reinterpret_cast<uint32_t*>(out + pixel(t) * out_ps + hc + dd) =
          pack_bf16(k2.x + v2.x, k2.y + v2.y);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int nt = LP / 8;                  // n8 key tiles, even
  const int nkb = (nt + KT - 1) / KT;     // key blocks
  for (int s = warp; s < LP / 16; s += WARPS) {
    const int r0 = s * 16;
    float o[DN][4];
#pragma unroll
    for (int u = 0; u < DN; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;

    if constexpr (attends(MODE)) {
      float S[KT][4];
      // S = Q·Kᵀ for key block kb; keys past L are -inf. Q's fragments are
      // loaded here, so they hold no registers between the passes.
      const auto scores = [&](int kb) {
        uint32_t qa[DK][4];
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          ldsm_x4(qa[kk], Qs + (r0 + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[kk][e] = scale_bf16x2(qa[kk][e], scale);
        }
#pragma unroll
        for (int t2 = 0; t2 < KT / 2; ++t2) {
          const int t = kb * KT + 2 * t2;  // global n8 tile of the pair's first
#pragma unroll
          for (int e = 0; e < 4; ++e) S[2 * t2][e] = S[2 * t2 + 1][e] = 0.f;
          if (t < nt) {
#pragma unroll
            for (int kk = 0; kk < DK; ++kk) {
              uint32_t kb4[4];
              ldsm_x4(kb4, Ks + (t * 8 + (lane >> 4) * 8 + (lane & 7)) * DP + kk * 16 +
                               ((lane >> 3) & 1) * 8);
              mma_bf16(S[2 * t2], qa[kk], kb4[0], kb4[1]);
              mma_bf16(S[2 * t2 + 1], qa[kk], kb4[2], kb4[3]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if ((t + h) * 8 + 2 * q4 + (e & 1) >= L) S[2 * t2 + h][e] = -INFINITY;
        }
      };
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
      if constexpr (softmaxed(MODE)) {
        for (int kb = 0; kb < nkb; ++kb) {
          scores(kb);
#pragma unroll
          for (int t = 0; t < KT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], S[t][e]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
        for (int kb = 0; kb < nkb; ++kb) {
          if (nkb > 1) scores(kb);
#pragma unroll
          for (int t = 0; t < KT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ex = expf(S[t][e] - mx[e >> 1]);
              sum[e >> 1] += ex;
              if (nkb == 1) S[t][e] = ex;  // kept for P: one block is not recomputed
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        }
      }
      const float inv_l = 1.f / (float)L;
      for (int kb = 0; kb < nkb; ++kb) {
        if (!softmaxed(MODE) || nkb > 1) scores(kb);
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool key = (kb * KT + t) * 8 + 2 * q4 + (e & 1) < L;
            float p;
            if constexpr (softmaxed(MODE)) {
              const float ex = nkb == 1 ? S[t][e] : expf(S[t][e] - mx[e >> 1]);
              p = round_bf16(ex / sum[e >> 1]);
            } else if constexpr (MODE == NO_SOFTMAX) {
              p = round_bf16(S[t][e] * 1e-4f);
            } else {
              p = round_bf16(S[t][e] * inv_l);
            }
            S[t][e] = key ? p : 0.f;
          }
        if constexpr (MODE == SOFTMAX) {
          // o[a][·] gathers P's columns j with j / 8 % DN == a: lane q4 then
          // holds output channels 8a + 2·q4 (+1) of rows g and g + 8.
#pragma unroll
          for (int t = 0; t < KT; ++t) {
            const int tg = kb * KT + t;
#pragma unroll
            for (int a = 0; a < DN; ++a)
              if (tg < nt && tg % DN == a)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[a][e] += S[t][e];
          }
        } else {
#pragma unroll
          for (int t2 = 0; t2 < KT / 2; ++t2) {
            const int t = kb * KT + 2 * t2;
            if (t >= nt) continue;
            const uint32_t pa[4] = {pack_bf16(S[2 * t2][0], S[2 * t2][1]),
                                    pack_bf16(S[2 * t2][2], S[2 * t2][3]),
                                    pack_bf16(S[2 * t2 + 1][0], S[2 * t2 + 1][1]),
                                    pack_bf16(S[2 * t2 + 1][2], S[2 * t2 + 1][3])};
            const bf16* vrow = Vs + (t * 8 + ((lane >> 3) & 1) * 8 + (lane & 7)) * DP;
#pragma unroll
            for (int u = 0; u + 1 < DN; u += 2) {
              uint32_t vb[4];
              ldsm_x4<true>(vb, vrow + (u + (lane >> 4)) * 8);
              mma_bf16(o[u], pa, vb[0], vb[1]);
              mma_bf16(o[u + 1], pa, vb[2], vb[3]);
            }
            if constexpr (DN % 2) {
              uint32_t vb[2];
              ldsm_x2_trans(vb, vrow + (DN - 1) * 8);
              mma_bf16(o[DN - 1], pa, vb[0], vb[1]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < DN; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              Vs + (r0 + g + 8 * h) * DP + 8 * u + 2 * q4));
          o[u][2 * h] = v2.x;
          o[u][2 * h + 1] = v2.y;
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0 + g + 8 * h;
      if (i >= L) continue;
      const int ti = i / w_sp, tj = i % w_sp;
      bf16* dst = out + pixel(i) * out_ps + hc;
#pragma unroll
      for (int u = 0; u < DN; ++u) {
        const int dd = 8 * u + 2 * q4;
        const float o0 = o[u][2 * h], o1 = o[u][2 * h + 1];
        if constexpr (!with_lepe(MODE)) {
          *reinterpret_cast<uint32_t*>(dst + dd) = pack_bf16(o0, o1);
          continue;
        }
        float c0 = 0.f, c1 = 0.f;
        for (int di = -1; di <= 1; ++di) {
          const int r = ti + di;
          if (r < 0 || r >= h_sp) continue;
          for (int dj = -1; dj <= 1; ++dj) {
            const int c = tj + dj;
            if (c < 0 || c >= w_sp) continue;
            const float2 w2 = *reinterpret_cast<const float2*>(Tw + ((di + 1) * 3 + dj + 1) * D + dd);
            const float2 v2 =
                unpack_bf16(*reinterpret_cast<const uint32_t*>(Vs + (r * w_sp + c) * DP + dd));
            c0 += w2.x * v2.x;
            c1 += w2.y * v2.y;
          }
        }
        const float2 b2 = *reinterpret_cast<const float2*>(Tw + 9 * D + dd);
        if (PALLAS) {
          *reinterpret_cast<uint32_t*>(dst + dd) = pack_bf16(o0 + (c0 + b2.x), o1 + (c1 + b2.y));
        } else {
          const float l0 = round_bf16(round_bf16(c0) + b2.x);
          const float l1 = round_bf16(round_bf16(c1) + b2.y);
          *reinterpret_cast<uint32_t*>(dst + dd) =
              pack_bf16(round_bf16(o0) + l0, round_bf16(o1) + l1);
        }
      }
    }
  }
}

// The COPY mode's body: the tile's reads and its write, nothing between.
template <int D>
__device__ __forceinline__ void copy_tile(const bf16* __restrict__ qp,
                                          const bf16* __restrict__ kp,
                                          const bf16* __restrict__ vp, size_t in_ps,
                                          bf16* __restrict__ out, size_t out_ps, int H,
                                          int W, int h_sp, int w_sp, int win, int head) {
  const int L = h_sp * w_sp;
  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * h_sp, col0 = win % n_ww * w_sp;
  const int hc = head * D;
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    const int t = i / D, dd = i % D;
    const size_t m = ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
    const size_t p = m * in_ps + hc + dd;
    out[m * out_ps + hc + dd] = f2bf(round_bf16(bf2f(qp[p]) + bf2f(kp[p])) + bf2f(vp[p]));
  }
}

// --- the float32 tile (TPU.COMPUTE_DTYPE float32) --------------------------
//
// The same function of one (window, head) from float32 q, k, v: S =
// (q·scale)·kᵀ, the softmax, P·V and LePE all in float32, nothing rounded
// between them (at float32 the composition's and the Pallas kernel's
// roundings coincide: out = P·V + (conv(V, w) + b)). The products are FFMA
// on the CUDA cores: no tensor-core format keeps float32's products, and
// the function is bound by its bytes (4·L·d flops a token against 16·d
// bytes of q, k, v and the output; ~20 operations a byte is the card's
// FFMA ridge).
// Design: q (scaled as it lands), k and v of the (window, head) staged in
// shared memory, q at a row stride of D floats (its reads are broadcasts),
// k and v at D + 4 (a quarter-warp's 16-byte reads of eight consecutive
// rows fall in distinct banks); the LePE taps and bias beside them. Each
// warp takes QR = 4 query rows at a time: a lane takes keys lane, lane +
// 32, ... and forms their four scores from 16-byte reads of q and k, into
// the warp's rows of P in shared memory (a row stride of L rounded up to 4);
// the softmax's max and sum are warp reductions, and P is normalised in
// place (e / sum, as the reference divides); then a lane takes outputs
// (row, channel) lane, lane + 32, ... of the four rows, P·V from 16-byte
// reads of P's row and V's column, and adds LePE from the staged V. Shared
// memory grows with L·d (smem_bytes_f32), ~109 KB at L = 288, d = 24
// (base-384's stage 3): two CTAs an SM there, four at tiny-224's L <= 98.
constexpr int QR = 4;  // query rows a warp takes at once

__host__ __device__ constexpr int p_stride_f32(int L) { return (L + 3) / 4 * 4; }

template <int D>
__host__ __device__ constexpr size_t smem_bytes_f32(int L) {
  return sizeof(float) * ((size_t)L * D + 2 * (size_t)L * (D + 4) +
                          (size_t)WARPS * QR * p_stride_f32(L) + 10 * D);
}

// q, k, v point at channel 0 of the branch; pixel p of each starts at
// p * in_ps, of the output at p * out_ps (the pointers and in_ps·4 16-byte
// aligned: the wrappers check). LePE taps (9, cb) tap-major and bias (cb,)
// float32. win walks the windows as tile()'s.
template <int D>
__device__ __forceinline__ void tile_f32(const float* __restrict__ qp,
                                         const float* __restrict__ kp,
                                         const float* __restrict__ vp, size_t in_ps,
                                         const float* __restrict__ lepe_w,
                                         const float* __restrict__ lepe_b,
                                         float* __restrict__ out, size_t out_ps, int H, int W,
                                         int cb, int h_sp, int w_sp, float scale, int win,
                                         int head, float* smem) {
  static_assert(D % 8 == 0 && D <= 32, "head dims 16, 24, 32");
  constexpr int KS = D + 4;          // row stride of k and v
  constexpr int CH = D / 4;          // 16-byte chunks of a pixel's head slice
  constexpr int U = (QR * D + 31) / 32;  // outputs a lane takes in a row group
  const int L = h_sp * w_sp, PS = p_stride_f32(L);
  float* Qs = smem;
  float* Ks = Qs + L * D;
  float* Vs = Ks + L * KS;
  float* Ps = Vs + L * KS;                 // WARPS x QR rows of PS
  float* Tw = Ps + WARPS * QR * PS;        // 9 taps, then the bias; D each

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * h_sp, col0 = win % n_ww * w_sp;
  const int hc = head * D;
  const auto pixel = [&](int t) {
    return ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
  };

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH * 4;
    const size_t p = pixel(t) * in_ps + hc + c;
    cp_async16(Ks + t * KS + c, kp + p);
    cp_async16(Vs + t * KS + c, vp + p);
    float4 q4 = __ldg(reinterpret_cast<const float4*>(qp + p));
    q4.x *= scale;
    q4.y *= scale;
    q4.z *= scale;
    q4.w *= scale;
    *reinterpret_cast<float4*>(Qs + t * D + c) = q4;
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 10 * D; i += blockDim.x) {
    const int tap = i / D, dd = i % D;
    Tw[i] = tap < 9 ? lepe_w[tap * cb + hc + dd] : lepe_b[hc + dd];
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* P = Ps + warp * QR * PS;
  for (int r0 = warp * QR; r0 < L; r0 += WARPS * QR) {
    // Scores of the group's rows (a row past L repeats row L - 1, unstored).
    const float* qr[QR];
#pragma unroll
    for (int r = 0; r < QR; ++r) qr[r] = Qs + min(r0 + r, L - 1) * D;
    float mx[QR], sum[QR];
#pragma unroll
    for (int r = 0; r < QR; ++r) mx[r] = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float sc[QR] = {};
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(Ks + j * KS + d);
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr[r] + d);
          sc[r] = fmaf(q4.x, k4.x, sc[r]);
          sc[r] = fmaf(q4.y, k4.y, sc[r]);
          sc[r] = fmaf(q4.z, k4.z, sc[r]);
          sc[r] = fmaf(q4.w, k4.w, sc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        P[r * PS + j] = sc[r];
        mx[r] = fmaxf(mx[r], sc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      mx[r] = warp_max(mx[r]);
      sum[r] = 0.f;
    }
    for (int j = lane; j < L; j += 32)
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const float e = expf(P[r * PS + j] - mx[r]);
        P[r * PS + j] = e;
        sum[r] += e;
      }
#pragma unroll
    for (int r = 0; r < QR; ++r) sum[r] = warp_sum(sum[r]);
    // Normalised in place, and zeros past L up to PS (the 16-byte reads).
    for (int j = lane; j < PS; j += 32)
#pragma unroll
      for (int r = 0; r < QR; ++r) P[r * PS + j] = j < L ? P[r * PS + j] / sum[r] : 0.f;
    __syncwarp();

#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int o = lane + 32 * u, r = o / D, dd = o % D, i = r0 + r;
      if (o >= QR * D || i >= L) continue;
      const float* pr = P + r * PS;
      float acc = 0.f;
      for (int j = 0; j < L; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
        acc = fmaf(p4.x, Vs[j * KS + dd], acc);
        if (j + 1 < L) acc = fmaf(p4.y, Vs[(j + 1) * KS + dd], acc);
        if (j + 2 < L) acc = fmaf(p4.z, Vs[(j + 2) * KS + dd], acc);
        if (j + 3 < L) acc = fmaf(p4.w, Vs[(j + 3) * KS + dd], acc);
      }
      const int ti = i / w_sp, tj = i % w_sp;
      float c = 0.f;
      for (int di = -1; di <= 1; ++di) {
        const int rr = ti + di;
        if (rr < 0 || rr >= h_sp) continue;
        for (int dj = -1; dj <= 1; ++dj) {
          const int cc = tj + dj;
          if (cc < 0 || cc >= w_sp) continue;
          c = fmaf(Tw[((di + 1) * 3 + dj + 1) * D + dd], Vs[(rr * w_sp + cc) * KS + dd], c);
        }
      }
      out[pixel(i) * out_ps + hc + dd] = acc + (c + Tw[9 * D + dd]);
    }
    __syncwarp();  // the group's P is rewritten by the next
  }
}

}  // namespace attn_tile
