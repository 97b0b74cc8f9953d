// One (window, head) of CSWin stripe attention + LePE, as a device function.
//
// The body of stripe_attention.cu's stripe_attention_kernel: it takes its
// window, head and shared memory as arguments instead of reading blockIdx,
// so that the one-tile-per-CTA kernel (stripe_attention.cu) and the
// persistent kernel that loops over tiles (block_pair.cu) run the same code
// and round the same way. The function, the two epilogue roundings and the
// layouts are documented at the top of stripe_attention.cu. Needs WARPS
// warps and smem_bytes<D>(L) bytes of shared memory.
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
#pragma once

#include "common.cuh"

namespace attn_tile {

constexpr int WARPS = 4;

enum Mode { FULL = 0, NO_LEPE = 1, NO_SOFTMAX = 2, COPY = 3, SOFTMAX = 4, STAGE = 5 };

template <int D>
constexpr size_t smem_bytes(int L) {
  return (size_t)(3 * L * (D + 1) + WARPS * L) * sizeof(float);
}

__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// q, k, v point at channel 0 of the branch; pixel p of each starts at
// p * in_ps, of the output at p * out_ps. TW: type of the LePE taps (9, cb)
// and bias (cb,), unread outside FULL. PALLAS: the epilogue's rounding in
// FULL. win walks the batch's windows (image-major, then window rows, then
// window columns).
template <int D, typename TW, bool PALLAS, int MODE = FULL>
__device__ __forceinline__ void tile(const bf16* __restrict__ qp,
                                     const bf16* __restrict__ kp,
                                     const bf16* __restrict__ vp, size_t in_ps,
                                     const TW* __restrict__ lepe_w,
                                     const TW* __restrict__ lepe_b,
                                     bf16* __restrict__ out, size_t out_ps, int H, int W,
                                     int cb, int h_sp, int w_sp, float scale, int win,
                                     int head, float* smem) {
  constexpr int LD = D + 1;
  const int L = h_sp * w_sp;
  float* Qs = smem;
  float* Ks = Qs + L * LD;
  float* Vs = Ks + L * LD;
  float* Ps = Vs + L * LD;  // one probability row per warp

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int b = win / (n_wh * n_ww);
  const int wi = (win / n_ww) % n_wh, wj = win % n_ww;
  const int row0 = wi * h_sp, col0 = wj * w_sp;
  const int hc = head * D;         // branch-local channel of this head

  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    const int t = i / D, dd = i % D;
    const int y = row0 + t / w_sp, x = col0 + t % w_sp;
    const size_t p = (((size_t)b * H + y) * W + x) * in_ps + hc + dd;
    Qs[t * LD + dd] = round_bf16(bf2f(qp[p]) * scale);
    Ks[t * LD + dd] = bf2f(kp[p]);
    Vs[t * LD + dd] = bf2f(vp[p]);
  }
  __syncthreads();
  if constexpr (MODE == STAGE) {
    for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
      const int t = i / D, dd = i % D;
      const size_t m = ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
      out[m * out_ps + hc + dd] = f2bf(Ks[t * LD + dd] + Vs[t * LD + dd]);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* P = Ps + warp * L;
  for (int i = warp; i < L; i += WARPS) {
    float q[D];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) q[dd] = Qs[i * LD + dd];
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float* kr = Ks + j * LD;
      float s = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) s += q[dd] * kr[dd];
      P[j] = s;
      mx = fmaxf(mx, s);
    }
    if constexpr (MODE == NO_SOFTMAX) {
      for (int j = lane; j < L; j += 32) P[j] = round_bf16(P[j] * 1e-4f);
    } else {
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(P[j] - mx);
        P[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < L; j += 32) P[j] = round_bf16(P[j] / sum);
    }
    __syncwarp();

    const int ti = i / w_sp, tj = i % w_sp;
    const size_t m = ((size_t)b * H + row0 + ti) * W + col0 + tj;
    for (int dd = lane; dd < D; dd += 32) {
      float o = 0.f;
      if constexpr (MODE == SOFTMAX) {
        for (int j = dd; j < L; j += D) o += P[j];
      } else {
        for (int j = 0; j < L; ++j) o += P[j] * Vs[j * LD + dd];
      }
      if constexpr (MODE != FULL) {
        out[m * out_ps + hc + dd] = f2bf(o);
        continue;
      }
      float conv = 0.f;
      for (int di = -1; di <= 1; ++di) {
        const int r = ti + di;
        if (r < 0 || r >= h_sp) continue;
        for (int dj = -1; dj <= 1; ++dj) {
          const int c = tj + dj;
          if (c < 0 || c >= w_sp) continue;
          conv += to_f(lepe_w[((di + 1) * 3 + dj + 1) * cb + hc + dd]) *
                  Vs[(r * w_sp + c) * LD + dd];
        }
      }
      if (PALLAS) {
        out[m * out_ps + hc + dd] = f2bf(o + (conv + to_f(lepe_b[hc + dd])));
      } else {
        const float lepe = round_bf16(round_bf16(conv) + to_f(lepe_b[hc + dd]));
        out[m * out_ps + hc + dd] = f2bf(round_bf16(o) + lepe);
      }
    }
    __syncwarp();
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

}  // namespace attn_tile
