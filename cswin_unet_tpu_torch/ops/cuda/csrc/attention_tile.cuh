// One (window, head) of CSWin stripe attention + LePE, as a device function.
//
// The body of stripe_attention.cu's stripe_attention_kernel: it takes its
// window, head and shared memory as arguments instead of reading blockIdx,
// so that the one-tile-per-CTA kernel (stripe_attention.cu) and the
// persistent kernel that loops over tiles (block_pair.cu) run the same code
// and round the same way. The function, the two epilogue roundings and the
// layouts are documented at the top of stripe_attention.cu. Needs WARPS
// warps and smem_bytes<D>(L) bytes of shared memory.
#pragma once

#include "common.cuh"

namespace attn_tile {

constexpr int WARPS = 4;

template <int D>
constexpr size_t smem_bytes(int L) {
  return (size_t)(3 * L * (D + 1) + WARPS * L) * sizeof(float);
}

__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// q, k, v point at channel 0 of the branch; pixel p of each starts at
// p * in_ps, of the output at p * out_ps. TW: type of the LePE taps (9, cb)
// and bias (cb,). PALLAS: the epilogue's rounding. win walks the batch's
// windows (image-major, then window rows, then window columns).
template <int D, typename TW, bool PALLAS>
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
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(P[j] - mx);
      P[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) P[j] = round_bf16(P[j] / sum);
    __syncwarp();

    const int ti = i / w_sp, tj = i % w_sp;
    const size_t m = ((size_t)b * H + row0 + ti) * W + col0 + tj;
    for (int dd = lane; dd < D; dd += 32) {
      float o = 0.f;
      for (int j = 0; j < L; ++j) o += P[j] * Vs[j * LD + dd];
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

}  // namespace attn_tile
