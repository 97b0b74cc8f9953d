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
// on the CUDA cores: no tensor-core format keeps float32's products. Bound:
// the FFMA work (4·L·d flops a token: 2·L·d for S, 2·L·d for P·V) against
// 16·d bytes of q, k, v and the output, so operations bound the card's time
// at L >= ~100 and bytes below; shared-memory loads and latency bound a
// simple kernel's long before either.
// Design (register micro-tiles; shared memory that grows with L·d only):
//   * k and v of the (window, head) staged by 16-byte cp.async copies at a
//     row stride of D + 4 floats (a quarter-warp's 16-byte reads of eight
//     consecutive rows fall in distinct banks), the LePE taps and bias
//     beside them.
//   * each warp takes QR = 8 query rows at a time, independently of the
//     other warps (no block barrier after the staging): their q rows arrive
//     by cp.async in the warp's own double buffer, the next group's while
//     this one computes, and are scaled in place.
//   * S: a lane takes keys lane, lane + 32, ... in up to SLOTS = 3 key
//     slots at once, an 8 x 3 block of scores in registers; a 16-byte read
//     of q (a broadcast) feeds three keys and a 16-byte read of k eight
//     rows. Each score is one fmaf chain over d in order. The scores go to
//     the warp's rows of shared memory, a key's eight rows as two 16-byte
//     quads (quad order swizzled by key, so that eight lanes' stores fall in
//     distinct banks); exp(s - max) replaces them, and the rows' sums are
//     warp reductions.
//   * P·V: lane (key group kg = lane / 4, channel group cg = lane % 4) sums
//     the eight rows' e·V over keys kg, kg + 8, ... for channels cg·D/4 ..,
//     an 8 x D/4 block in registers from 16-byte reads of e and V; a
//     reduce-scatter over the eight key groups (three shuffle rounds, a
//     fixed tree) leaves lane (kg, cg) row kg's sum of its channels, which
//     it scales by 1 / sum (the softmax's division, once an output) and to
//     which it adds LePE from the staged V.
// ~106 KB at L = 288, d = 24 (base-384's stage 3): two CTAs an SM.
constexpr int QR = 8;     // query rows a warp takes at once
constexpr int SLOTS = 3;  // key slots of 32 keys a lane scores at once

__host__ __device__ constexpr int key_slots(int L) { return (L + 31) / 32; }

// Dynamic shared memory of the float32 tile at a window of L tokens: k and
// v, the LePE taps and bias, and per warp two QR-row q buffers and QR rows
// of scores over the window's key slots.
template <int D>
__host__ __device__ constexpr size_t smem_bytes_f32(int L) {
  return sizeof(float) * (2 * (size_t)L * (D + 4) + 10 * (size_t)D +
                          (size_t)WARPS * QR * (2 * D + 32 * (size_t)key_slots(L)));
}

// The position of (key j, quad q) in a warp's score rows: QR / 4 quads of
// four rows a key, the quad order swizzled by key bit 2 where there are two.
template <int ROWS>
__device__ __forceinline__ int quad_pos(int j, int q) {
  if constexpr (ROWS == 4)
    return j * 4;
  else
    return j * 8 + 4 * (q ^ ((j >> 2) & 1));
}

// acc[m][r] = Σ_d A[r][d]·B[key_m][d], one fmaf chain in d's order, for ROWS
// rows of A (row stride D; the same address in every lane) and keys key_m =
// j0 + 32·m + lane of B (row stride D + 4), clamped to the window's last.
template <int D, int ROWS, int M>
__device__ __forceinline__ void dots(const float* A, const float* B, int j0, int L, int lane,
                                     float (&acc)[M][ROWS]) {
  constexpr int KS = D + 4;
  const float* b[M];
#pragma unroll
  for (int m = 0; m < M; ++m) b[m] = B + min(j0 + 32 * m + lane, L - 1) * KS;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[m][r] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 b4[M];
#pragma unroll
    for (int m = 0; m < M; ++m) b4[m] = *reinterpret_cast<const float4*>(b[m] + d);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(A + r * D + d);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        acc[m][r] = fmaf(a4.x, b4[m].x, acc[m][r]);
        acc[m][r] = fmaf(a4.y, b4[m].y, acc[m][r]);
        acc[m][r] = fmaf(a4.z, b4[m].z, acc[m][r]);
        acc[m][r] = fmaf(a4.w, b4[m].w, acc[m][r]);
      }
    }
  }
}

// The scores of ROWS rows against M key slots from slot m0, stored at
// quad_pos in S; with MAX, mx[r] takes the maximum over the keys inside the
// window.
template <int D, int ROWS, int M, bool MAX>
__device__ __forceinline__ void score_slots(const float* A, const float* B, float* S, int m0,
                                            int L, int lane, float (&mx)[ROWS]) {
  float acc[M][ROWS];
  dots<D, ROWS, M>(A, B, 32 * m0, L, lane, acc);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = 32 * (m0 + m) + lane;
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q)
      *reinterpret_cast<float4*>(S + quad_pos<ROWS>(j, q)) =
          make_float4(acc[m][4 * q], acc[m][4 * q + 1], acc[m][4 * q + 2], acc[m][4 * q + 3]);
    if constexpr (MAX)  // no branch: a key past the window adds -inf
#pragma unroll
      for (int r = 0; r < ROWS; ++r) mx[r] = fmaxf(mx[r], j < L ? acc[m][r] : -INFINITY);
  }
}

// All the window's key slots, SLOTS at a time.
template <int D, int ROWS, bool MAX = true>
__device__ __forceinline__ void scores(const float* A, const float* B, float* S, int L,
                                       int lane, float (&mx)[ROWS]) {
  const int ns = key_slots(L);
  int m0 = 0;
  for (; m0 + SLOTS <= ns; m0 += SLOTS)
    score_slots<D, ROWS, SLOTS, MAX>(A, B, S, m0, L, lane, mx);
  if (ns - m0 == 2)
    score_slots<D, ROWS, 2, MAX>(A, B, S, m0, L, lane, mx);
  else if (ns - m0 == 1)
    score_slots<D, ROWS, 1, MAX>(A, B, S, m0, L, lane, mx);
}

// Σ_{j < L} E[j][r]·B[j][c] for the ROWS rows of a warp's score rows E
// (quad_pos) and every channel c of B (row stride D + 4), reduced over the
// lanes' eight key groups and scattered: lane (kg = lane / 4, cg = lane %
// 4) returns in out[u] row row_of(lane)'s sum for channel cg·D/4 + u (ROWS
// = 8), or for channel cg·D/4 + (kg % 2)·D/8 + u (ROWS = 4: two lanes share
// a row's channel group). Each lane sums its keys kg, kg + 8, ... in
// order, the key groups in a fixed tree.
template <int D, int ROWS>
__device__ __forceinline__ void products(const float* E, const float* B, int L, int lane,
                                         float (&out)[ROWS == 8 ? D / 4 : D / 8]) {
  constexpr int KS = D + 4, CL = D / 4;
  static_assert(CL % 2 == 0, "channel groups of an even width");
  const int kg = lane >> 2, cg = lane & 3;
  float a[ROWS][CL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int u = 0; u < CL; ++u) a[r][u] = 0.f;
  for (int j = kg; j < L; j += 8) {
    float e[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q) {
      const float4 e4 = *reinterpret_cast<const float4*>(E + quad_pos<ROWS>(j, q));
      e[4 * q] = e4.x;
      e[4 * q + 1] = e4.y;
      e[4 * q + 2] = e4.z;
      e[4 * q + 3] = e4.w;
    }
    float b[CL];
    const float* bj = B + j * KS + cg * CL;
    if constexpr (CL % 4 == 0) {
#pragma unroll
      for (int u = 0; u < CL; u += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(bj + u);
        b[u] = b4.x;
        b[u + 1] = b4.y;
        b[u + 2] = b4.z;
        b[u + 3] = b4.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < CL; u += 2) {
        const float2 b2 = *reinterpret_cast<const float2*>(bj + u);
        b[u] = b2.x;
        b[u + 1] = b2.y;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int u = 0; u < CL; ++u) a[r][u] = fmaf(e[r], b[u], a[r][u]);
  }
  // Reduce-scatter over the key groups (lane bits 4, 3, 2): each round a
  // lane keeps half of what it holds and adds its partner's copy of it.
  constexpr unsigned FULL = 0xffffffffu;
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  if constexpr (ROWS == 8) {
    float h[4][CL], g[2][CL];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < CL; ++u) {
        const float keep = hi16 ? a[r + 4][u] : a[r][u], give = hi16 ? a[r][u] : a[r + 4][u];
        h[r][u] = keep + __shfl_xor_sync(FULL, give, 16);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < CL; ++u) {
        const float keep = hi8 ? h[r + 2][u] : h[r][u], give = hi8 ? h[r][u] : h[r + 2][u];
        g[r][u] = keep + __shfl_xor_sync(FULL, give, 8);
      }
#pragma unroll
    for (int u = 0; u < CL; ++u) {
      const float keep = hi4 ? g[1][u] : g[0][u], give = hi4 ? g[0][u] : g[1][u];
      out[u] = keep + __shfl_xor_sync(FULL, give, 4);
    }
  } else {
    float h[2][CL], g[CL];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < CL; ++u) {
        const float keep = hi16 ? a[r + 2][u] : a[r][u], give = hi16 ? a[r][u] : a[r + 2][u];
        h[r][u] = keep + __shfl_xor_sync(FULL, give, 16);
      }
#pragma unroll
    for (int u = 0; u < CL; ++u) {
      const float keep = hi8 ? h[1][u] : h[0][u], give = hi8 ? h[0][u] : h[1][u];
      g[u] = keep + __shfl_xor_sync(FULL, give, 8);
    }
#pragma unroll
    for (int u = 0; u < CL / 2; ++u) {
      const float keep = hi4 ? g[u + CL / 2] : g[u], give = hi4 ? g[u] : g[u + CL / 2];
      out[u] = keep + __shfl_xor_sync(FULL, give, 4);
    }
  }
}

// The row of the warp's ROWS rows that products() leaves a lane.
template <int ROWS>
__device__ __forceinline__ int row_of(int lane) {
  return ROWS == 8 ? lane >> 2 : lane >> 3;
}

// v[r] of the row that products() leaves a lane, without indexing a
// register array by a lane-dependent value.
template <int ROWS>
__device__ __forceinline__ float pick(const float (&v)[ROWS], int lane) {
  const int r = row_of<ROWS>(lane);
  float out = v[0];
#pragma unroll
  for (int i = 1; i < ROWS; ++i)
    if (r == i) out = v[i];
  return out;
}

// cp.async copies of ROWS rows of a window's (L, D) head slice from row i0
// (a row past L repeats row L - 1) into a warp's buffer (row stride D); one
// commit group. src: the head's channel 0 at the window's first pixel (the
// image's row r, column c at src + ((r·W) + c)·ps).
template <int D, int ROWS>
__device__ __forceinline__ void fetch_rows(float* dst, const float* src, size_t ps, int W,
                                           int w_sp, int i0, int L, int lane) {
  constexpr int CH = D / 4;
  for (int idx = lane; idx < ROWS * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH * 4, t = min(i0 + r, L - 1);
    cp_async16(dst + r * D + c, src + ((size_t)(t / w_sp) * W + t % w_sp) * ps + c);
  }
  cp_async_commit();
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
  constexpr int KS = D + 4;  // row stride of k and v
  constexpr int CH = D / 4;  // 16-byte chunks of a pixel's head slice
  constexpr int CL = D / 4;  // channels of a lane's output
  const int L = h_sp * w_sp, LS = 32 * key_slots(L);
  float* Ks = smem;
  float* Vs = Ks + L * KS;
  float* Tw = Vs + L * KS;  // 9 taps, then the bias; D each
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Qb = Tw + 10 * D + warp * QR * (2 * D + LS);  // the warp's two q buffers
  float* Sb = Qb + 2 * QR * D;                          // and its score rows

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
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 10 * D; i += blockDim.x) {
    const int tap = i / D, dd = i % D;
    Tw[i] = tap < 9 ? lepe_w[tap * cb + hc + dd] : lepe_b[hc + dd];
  }
  const int groups = (L + QR - 1) / QR;
  const float* q0 = qp + pixel(0) * in_ps + hc;  // the window's first pixel
  if (warp < groups) fetch_rows<D, QR>(Qb, q0, in_ps, W, w_sp, warp * QR, L, lane);
  cp_async_wait<0>();
  __syncthreads();

  const int kg = lane >> 2, cg = lane & 3;
  for (int g = warp, t = 0; g < groups; g += WARPS, ++t) {
    float* Q = Qb + (t & 1) * QR * D;
    if (t > 0) {
      cp_async_wait<0>();
      __syncwarp();
    }
    for (int i = lane; i < QR * D; i += 32) Q[i] *= scale;
    __syncwarp();
    if (g + WARPS < groups)
      fetch_rows<D, QR>(Qb + ((t + 1) & 1) * QR * D, q0, in_ps, W, w_sp, (g + WARPS) * QR, L,
                        lane);
    float mx[QR], sum[QR], inv[QR];
#pragma unroll
    for (int r = 0; r < QR; ++r) mx[r] = -INFINITY;
    scores<D, QR>(Q, Ks, Sb, L, lane, mx);
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      mx[r] = warp_max(mx[r]);
      sum[r] = 0.f;
    }
    for (int j = lane; j < L; j += 32)
#pragma unroll
      for (int q = 0; q < QR / 4; ++q) {
        float4* p = reinterpret_cast<float4*>(Sb + quad_pos<QR>(j, q));
        float4 e = *p;
        e.x = expf(e.x - mx[4 * q]);
        e.y = expf(e.y - mx[4 * q + 1]);
        e.z = expf(e.z - mx[4 * q + 2]);
        e.w = expf(e.w - mx[4 * q + 3]);
        *p = e;
        sum[4 * q] += e.x;
        sum[4 * q + 1] += e.y;
        sum[4 * q + 2] += e.z;
        sum[4 * q + 3] += e.w;
      }
#pragma unroll
    for (int r = 0; r < QR; ++r) inv[r] = 1.f / warp_sum(sum[r]);
    __syncwarp();
    float o[CL];
    products<D, QR>(Sb, Vs, L, lane, o);
    const int i = g * QR + kg;
    if (i < L) {
      const float iv = pick<QR>(inv, lane);
      const int ti = i / w_sp, tj = i % w_sp;
      float y[CL];
#pragma unroll
      for (int u = 0; u < CL; ++u) {
        const int dd = cg * CL + u;
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
        y[u] = o[u] * iv + (c + Tw[9 * D + dd]);
      }
      float* dst = out + pixel(i) * out_ps + hc + cg * CL;
#pragma unroll
      for (int u = 0; u < CL; u += 2)
        *reinterpret_cast<float2*>(dst + u) = make_float2(y[u], y[u + 1]);
    }
    __syncwarp();  // the group's scores are rewritten by the next
  }
}

}  // namespace attn_tile
