// Backward of one CSWin stripe branch (window attention + LePE).
//
// Reads q, k and v straight from the forward's (B, H, W, 3C) qkv output and
// the branch's output gradient dO from a (B, H, W, C) tensor, both at the
// branch's channel offset `ch_off`, with strides, as the forward does. Per
// (window, head) it recomputes the scores and the float32 softmax (L <= 98
// and d = 32 at 224², so nothing is saved by the forward) and applies the
// softmax-attention vjp with the rounding points of the JAX backward:
//   S  = bf16(q·scale)·Kᵀ,  P = softmax(S) (f32),  P_b = bf16(P)
//   dV = P_bᵀ·dO            dP = dO·Vᵀ
//   dS = P∘(dP − rowsum(dP∘P)),  dS_b = bf16(dS)
//   dQ = dS_b·K·scale       dK = dS_bᵀ·bf16(q·scale)
// and the LePE backward: dV += the transposed 3x3 depthwise conv of dO,
// zero padded at the window's borders; per-(window, head) float32 partials
// of the LePE weight gradient dW[tap][c] = Σ_t dO[t][c]·V[t + tap][c] and
// of the bias gradient Σ_t dO[t][c] (the wrapper sums them over windows).
// dQ, dK and dV land in bf16 at the branch's channel offset of the q, k and
// v thirds of a (B, H, W, 3C) dqkv buffer, so both branches of a block fill
// one buffer that feeds the qkv weight-gradient and dX products directly.
//
// Replaces: the attention + LePE part of the TPU block backward,
//   cswin_unet_tpu/ops/pallas/cswin_block.py::_block_bwd_kernel_xt, i.e.
//   _attn_windows_bwd (:617-661) and _lepe_windows_bwd (:753-800). The port
//   has one NHWC layout, so there is no transposed (xt) copy of the vertical
//   branch and no column un-split of dW_qkv afterwards.
// Bound on the H100: like the forward, many tiny problems: ~10·L·d flops per
//   token (four L x L x d products and the score recompute) against 8·d
//   bytes read and 6·d written, so latency and launch shape, not the tensor
//   cores, set the time.
// Design: one block of 4 warps per (window, head). q (pre-scaled and
//   rounded), k, v and dO of the window sit in shared memory as float32
//   rows padded to d + 1 (no bank conflicts across rows), with two L x L
//   float32 tiles for P_b and dS_b (128 KB at L = 98). Pass 1: a warp owns a
//   query row — lanes split the keys for S, the softmax, dP and dS (warp
//   shuffles for max, sum and rowsum), then split the head dim for dQ.
//   Pass 2: a warp owns a key column — lanes split the head dim for dK, dV
//   and the LePE transpose conv. Pass 3: threads split (tap, channel) pairs
//   for the LePE weight and bias partials.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
stripe_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                            const bf16* __restrict__ lepe_w, bf16* __restrict__ dqkv,
                            float* __restrict__ dlw_part, float* __restrict__ dlb_part,
                            int H, int W, int C, int ch_off, int cb, int h_sp, int w_sp,
                            float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  const int L = h_sp * w_sp;
  float* Qs = smem;
  float* Ks = Qs + L * LD;
  float* Vs = Ks + L * LD;
  float* Os = Vs + L * LD;   // dO
  float* Ps = Os + L * LD;   // P, then bf16(P), L x L
  float* Ss = Ps + L * L;    // dP, then bf16(dS), L x L

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int win = blockIdx.x;
  const int b = win / (n_wh * n_ww);
  const int wi = (win / n_ww) % n_wh, wj = win % n_ww;
  const int row0 = wi * h_sp, col0 = wj * w_sp;
  const int head = blockIdx.y;
  const int hc = head * D;         // branch-local channel of this head
  const int c0 = ch_off + hc;      // channel in the C-wide layout
  const size_t C3 = 3 * (size_t)C;
  auto token = [&](int t) {        // row of token t in the (B·H·W) layout
    return ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
  };

  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    const int t = i / D, dd = i % D;
    const size_t m = token(t);
    const bf16* p = qkv + m * C3 + c0 + dd;
    Qs[t * LD + dd] = round_bf16(bf2f(p[0]) * scale);
    Ks[t * LD + dd] = bf2f(p[C]);
    Vs[t * LD + dd] = bf2f(p[2 * C]);
    Os[t * LD + dd] = bf2f(dout[m * C + c0 + dd]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Pass 1: one query row per warp.
  for (int i = warp; i < L; i += WARPS) {
    float q[D], o[D];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      q[dd] = Qs[i * LD + dd];
      o[dd] = Os[i * LD + dd];
    }
    float* P = Ps + i * L;
    float* S = Ss + i * L;
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
    float delta = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = P[j] / sum;
      const float* vr = Vs + j * LD;
      float dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) dp += o[dd] * vr[dd];
      P[j] = p;
      S[j] = dp;
      delta += dp * p;
    }
    delta = warp_sum(delta);
    for (int j = lane; j < L; j += 32) {
      const float p = P[j];
      S[j] = round_bf16(p * (S[j] - delta));
      P[j] = round_bf16(p);
    }
    __syncwarp();
    const size_t m = token(i);
    for (int dd = lane; dd < D; dd += 32) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc += S[j] * Ks[j * LD + dd];
      dqkv[m * C3 + c0 + dd] = f2bf(acc * scale);
    }
    __syncwarp();
  }
  __syncthreads();

  // Pass 2: one key column per warp — dK, dV and the LePE transpose conv.
  for (int j = warp; j < L; j += WARPS) {
    const int tr = j / w_sp, tc = j % w_sp;
    const size_t m = token(j);
    for (int dd = lane; dd < D; dd += 32) {
      float dk = 0.f, dv = 0.f;
      for (int i = 0; i < L; ++i) {
        dk += Ss[i * L + j] * Qs[i * LD + dd];
        dv += Ps[i * L + j] * Os[i * LD + dd];
      }
      for (int di = -1; di <= 1; ++di) {
        const int r = tr - di;
        if (r < 0 || r >= h_sp) continue;
        for (int dj = -1; dj <= 1; ++dj) {
          const int c = tc - dj;
          if (c < 0 || c >= w_sp) continue;
          dv += bf2f(lepe_w[((di + 1) * 3 + dj + 1) * cb + hc + dd]) *
                Os[(r * w_sp + c) * LD + dd];
        }
      }
      dqkv[m * C3 + C + c0 + dd] = f2bf(dk);
      dqkv[m * C3 + 2 * C + c0 + dd] = f2bf(dv);
    }
  }

  // Pass 3: LePE weight (9 taps) and bias partials of this (window, head).
  for (int idx = threadIdx.x; idx < 10 * D; idx += blockDim.x) {
    const int tap = idx / D, dd = idx % D;
    float s = 0.f;
    if (tap == 9) {
      for (int t = 0; t < L; ++t) s += Os[t * LD + dd];
      dlb_part[(size_t)win * cb + hc + dd] = s;
      continue;
    }
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
    for (int t = 0; t < L; ++t) {
      const int r = t / w_sp + di, c = t % w_sp + dj;
      if (r < 0 || r >= h_sp || c < 0 || c >= w_sp) continue;
      s += Os[t * LD + dd] * Vs[(r * w_sp + c) * LD + dd];
    }
    dlw_part[((size_t)win * 9 + tap) * cb + hc + dd] = s;
  }
}

template <int D>
cudaError_t launch(const bf16* qkv, const bf16* dout, const bf16* lw, bf16* dqkv,
                   float* dlw, float* dlb, int B, int H, int W, int C, int ch_off, int cb,
                   int heads, int h_sp, int w_sp, float scale, cudaStream_t stream) {
  const int L = h_sp * w_sp;
  const size_t smem = (size_t)(4 * L * (D + 1) + 2 * L * L) * sizeof(float);
  cudaError_t err = allow_smem(stripe_attention_bwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (H / h_sp) * (W / w_sp), heads);
  stripe_attention_bwd_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
      qkv, dout, lw, dqkv, dlw, dlb, H, W, C, ch_off, cb, h_sp, w_sp, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv: (B, H, W, 3C) bf16; dout: (B, H, W, C) bf16; lepe_w: (9, cb) bf16
// (tap-major, tap = di·3 + dj); dqkv: (B, H, W, 3C) bf16, written at
// channels [ch_off, ch_off + cb) of each third; dlw_part: (windows, 9, cb)
// and dlb_part: (windows, cb) float32. head_dim = cb / heads must be 16, 24
// or 32; 4·L·(d + 1) + 2·L² floats of shared memory must fit in 227 KB
// (L <= 200 at d = 32; checked by the wrapper).
CSWIN_API int cswin_stripe_attention_bwd(const void* qkv, const void* dout,
                                         const void* lepe_w, void* dqkv, void* dlw_part,
                                         void* dlb_part, int B, int H, int W, int C,
                                         int ch_off, int cb, int heads, int h_sp,
                                         int w_sp, float scale, void* stream) {
  const bf16* q = (const bf16*)qkv;
  const bf16* o = (const bf16*)dout;
  const bf16* lw = (const bf16*)lepe_w;
  bf16* g = (bf16*)dqkv;
  float* dw = (float*)dlw_part;
  float* db = (float*)dlb_part;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cb / heads) {
    case 16: return (int)launch<16>(q, o, lw, g, dw, db, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 24: return (int)launch<24>(q, o, lw, g, dw, db, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 32: return (int)launch<32>(q, o, lw, g, dw, db, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
