// CSWin stripe-window attention core with LePE, for one branch of a block.
//
// Two C entries over one device function, which differ only in where q, k
// and v come from and in the epilogue's rounding:
//
// cswin_stripe_attention (the fused block chain): input is the block's qkv
//   GEMM output, (B, H, W, 3C) bf16 NHWC: the branch reads q, k and v at
//   channel offset `ch_off` of the q, k and v thirds with strides, so no
//   window copy ever goes to memory. Per (window, head):
//     out = bf16(P·V) + LePE(V),   LePE = bf16(bf16(conv(V, w)) + b)
//   with bf16 taps and bias, the rounding of the JAX composition.
// cswin_attention (the `pallas` route, one branch from separate q, k, v):
//   three base pointers that share a pixel stride, so q, k and v may be
//   channel slices of one qkv tensor. Per (window, head):
//     out = bf16(P·V + conv(V, w) + b)
//   with float32 taps and bias and one rounding, as the Pallas kernel.
// In both, P = bf16(softmax(bf16(q·scale) · kᵀ)), scores, softmax and P·V
// in float32, and LePE is a depthwise 3x3 conv on V inside the window, zero
// padded at the window's borders (not the image's). The result lands at the
// branch's channel offset of the output, so the two branches' concat costs
// nothing.
//
// Replaces: the attention part of the fused TPU block,
//   cswin_unet_tpu/ops/pallas/cswin_block.py::_block_kernel_xt (both stripe
//   branches) and ::_block_kernel (last-stage full window); and
//   cswin_unet_tpu/ops/pallas/cswin_attention.py::_cswin_attention_pallas_fwd
//   (pallas_call :169, body _kernel :66).
// Bound on the H100: many tiny problems (L <= 98 tokens, head dim 32 at
//   224²): ~4·L·d flops per token against 6·d bytes of q, k, v read, so
//   memory bounds the function and latency and launch shape matter more
//   than tensor-core rate.
// Design: one block of 4 warps per (window, head). q (pre-scaled and
//   rounded), k and v of the window are staged in shared memory as float32
//   with a padded row (d + 1) so that lanes reading different rows hit
//   different banks. Each warp owns one query row at a time: lanes compute
//   the row's scores, a warp-shuffle max / sum gives the softmax, and lanes
//   then split the head dim for P·V and the 9-tap LePE. No L x L score tile
//   is kept, so shared memory grows only with L·d.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// q, k, v point at channel 0 of the branch; pixel p of each starts at
// p * in_ps, of the output at p * out_ps. TW: type of the LePE taps (9, cb)
// and bias (cb,). PALLAS: the epilogue's rounding (see the top of the file).
template <int D, typename TW, bool PALLAS>
__global__ void __launch_bounds__(WARPS * 32)
stripe_attention_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp,
                        const bf16* __restrict__ vp, size_t in_ps,
                        const TW* __restrict__ lepe_w, const TW* __restrict__ lepe_b,
                        bf16* __restrict__ out, size_t out_ps, int H, int W, int cb,
                        int h_sp, int w_sp, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  const int L = h_sp * w_sp;
  float* Qs = smem;
  float* Ks = Qs + L * LD;
  float* Vs = Ks + L * LD;
  float* Ps = Vs + L * LD;  // one probability row per warp

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int win = blockIdx.x;
  const int b = win / (n_wh * n_ww);
  const int wi = (win / n_ww) % n_wh, wj = win % n_ww;
  const int row0 = wi * h_sp, col0 = wj * w_sp;
  const int head = blockIdx.y;
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

template <int D, typename TW, bool PALLAS>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, size_t in_ps,
                   const TW* lw, const TW* lb, bf16* out, size_t out_ps, int B, int H,
                   int W, int cb, int heads, int h_sp, int w_sp, float scale,
                   cudaStream_t stream) {
  const int L = h_sp * w_sp;
  const size_t smem = (size_t)(3 * L * (D + 1) + WARPS * L) * sizeof(float);
  cudaError_t err = allow_smem(stripe_attention_kernel<D, TW, PALLAS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (H / h_sp) * (W / w_sp), heads);
  stripe_attention_kernel<D, TW, PALLAS><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, in_ps, lw, lb, out, out_ps, H, W, cb, h_sp, w_sp, scale);
  return cudaGetLastError();
}

template <typename TW, bool PALLAS>
int dispatch(const bf16* q, const bf16* k, const bf16* v, size_t in_ps, const TW* lw,
             const TW* lb, bf16* out, size_t out_ps, int B, int H, int W, int cb,
             int heads, int h_sp, int w_sp, float scale, cudaStream_t s) {
  switch (cb / heads) {
    case 16: return (int)launch<16, TW, PALLAS>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    case 24: return (int)launch<24, TW, PALLAS>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    case 32: return (int)launch<32, TW, PALLAS>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: (B, H, W, 3C) bf16; lepe_w: (9, cb) bf16 (tap-major, tap = di·3 + dj);
// lepe_b: (cb,) bf16; out: (B, H, W, C) bf16, written at channels
// [ch_off, ch_off + cb). head_dim = cb / heads must be 16, 24 or 32 (the
// head dims of the repo's configs: 32 at tiny-224, 24 at base-384, 16 in
// the narrow test geometries).
CSWIN_API int cswin_stripe_attention(const void* qkv, const void* lepe_w,
                                     const void* lepe_b, void* out, int B, int H,
                                     int W, int C, int ch_off, int cb, int heads,
                                     int h_sp, int w_sp, float scale,
                                     void* stream) {
  const bf16* q = (const bf16*)qkv + ch_off;
  return dispatch<bf16, false>(q, q + C, q + 2 * C, 3 * (size_t)C, (const bf16*)lepe_w,
                               (const bf16*)lepe_b, (bf16*)out + ch_off, C, B, H, W,
                               cb, heads, h_sp, w_sp, scale, (cudaStream_t)stream);
}

// q, k, v: (B, H, W, cb) bf16 views whose pixels all lie `pix_stride`
// elements apart, channels contiguous (for example q | k | v slices of one
// (B, H, W, 3C) tensor); lepe_w: (9, cb) float32, tap-major; lepe_b: (cb,)
// float32; out: (B, H, W, cb) bf16, contiguous. Head dims as above.
CSWIN_API int cswin_cswin_attention(const void* q, const void* k, const void* v,
                                    long long pix_stride, const void* lepe_w,
                                    const void* lepe_b, void* out, int B, int H, int W,
                                    int cb, int heads, int h_sp, int w_sp, float scale,
                                    void* stream) {
  return dispatch<float, true>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                               (size_t)pix_stride, (const float*)lepe_w,
                               (const float*)lepe_b, (bf16*)out, cb, B, H, W, cb, heads,
                               h_sp, w_sp, scale, (cudaStream_t)stream);
}
