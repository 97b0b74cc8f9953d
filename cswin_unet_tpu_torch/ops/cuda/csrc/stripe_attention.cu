// CSWin stripe-window attention core with LePE, for one branch of a block.
// The bf16 entries below; their float32 instances (cswin_stripe_attention_f32,
// cswin_cswin_attention_f32, on attn_tile::tile_f32) serve TPU.COMPUTE_DTYPE
// float32.
//
// Three C entries over one device function, which differ only in where q, k
// and v come from, in the epilogue's rounding and in the parts they run:
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
// cswin_window_attention (the block lab: attention alone, no LePE): q, k, v
//   as for cswin_attention. Per (window, head), by mode:
//     1  out = bf16(P·V)                      (attention, one rounding)
//     2  the same with the softmax stubbed, P = bf16(s · 1e-4): the two
//        products alone
//     3  out = bf16(bf16(q + k) + v): the copy floor, no arithmetic
//     4  the first product and the softmax alone, P's row folded to the
//        head's width: out[i, dd] = bf16(sum of P[i, j], j = dd, dd + d, ...)
//     5  out = bf16(k + v) through the tile's shared-memory staging of q, k
//        and v: what laying the window out for the products costs
// Wherever they are not stubbed, P = bf16(softmax(bf16(q·scale) · kᵀ)), scores,
// softmax and P·V in float32, and LePE is a depthwise 3x3 conv on V inside the window, zero
// padded at the window's borders (not the image's). The result lands at the
// branch's channel offset of the output, so the two branches' concat costs
// nothing.
//
// Replaces: the attention part of the fused TPU block,
//   cswin_unet_tpu/ops/pallas/cswin_block.py::_block_kernel_xt (both stripe
//   branches) and ::_block_kernel (last-stage full window); and
//   cswin_unet_tpu/ops/pallas/cswin_attention.py::_cswin_attention_pallas_fwd
//   (pallas_call :169, body _kernel :66). cswin_window_attention replaces
//   the attention-alone kernels of scripts/exp_attn.py:132, :140, :148 (one
//   head on rows or columns of the image; their merged, mid-batch and
//   pre-transposed variants are this function in other TPU layouts) and
//   scripts/exp_attn3.py:59 (k_full / k_off / k_smg over _attn_windows_hb
//   :868 and _attn_windows :1124 of cswin_block.py, k_dots, k_copy; k_softmax
//   and k_tile price the softmax and the head-block tiling of K and V for a
//   128-lane matrix unit: modes 4 and 5 price this tile's softmax and its
//   own staging, the same questions asked of this design).
// Bound on the H100: many tiny problems (L <= 98 tokens, head dim 32 at
//   224²): ~4·L·d flops per token against 6·d bytes of q, k, v read, so
//   memory bounds the function, and latency and launch shape decide how
//   close the kernel comes to it.
// Design: one block of 4 warps per (window, head), running the tile body of
//   attention_tile.cuh (shared with the persistent block kernels
//   block_pair.cu and block_one.cu): the window's q, k and v staged as bf16
//   in padded shared memory by 16-byte cp.async copies, both products on
//   the tensor cores (mma.sync m16n8k16, 16-query slabs a warp), the
//   softmax and P on the accumulator fragments in registers, and LePE from
//   the staged V in the accumulator layout. Shared memory grows with L·d
//   only (no L x L tile); many blocks an SM overlap one window's copies with
//   another's products.

#include "attention_tile.cuh"

namespace {

using attn_tile::WARPS;

// One (window, head) per CTA: blockIdx.x is the window, blockIdx.y the head.
template <int D, typename TW, bool PALLAS, int MODE>
__global__ void __launch_bounds__(WARPS * 32)
stripe_attention_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp,
                        const bf16* __restrict__ vp, size_t in_ps,
                        const TW* __restrict__ lepe_w, const TW* __restrict__ lepe_b,
                        bf16* __restrict__ out, size_t out_ps, int H, int W, int cb,
                        int h_sp, int w_sp, float scale) {
  extern __shared__ __align__(128) float smem[];
  if constexpr (MODE == attn_tile::COPY)
    attn_tile::copy_tile<D>(qp, kp, vp, in_ps, out, out_ps, H, W, h_sp, w_sp, blockIdx.x,
                            blockIdx.y);
  else
    attn_tile::tile<D, TW, PALLAS, MODE>(qp, kp, vp, in_ps, lepe_w, lepe_b, out, out_ps, H,
                                         W, cb, h_sp, w_sp, scale, blockIdx.x, blockIdx.y,
                                         smem);
}

template <int D, typename TW, bool PALLAS, int MODE>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, size_t in_ps,
                   const TW* lw, const TW* lb, bf16* out, size_t out_ps, int B, int H,
                   int W, int cb, int heads, int h_sp, int w_sp, float scale,
                   cudaStream_t stream) {
  const size_t smem = attn_tile::smem_bytes<D>(h_sp * w_sp);
  cudaError_t err = allow_smem(stripe_attention_kernel<D, TW, PALLAS, MODE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (H / h_sp) * (W / w_sp), heads);
  stripe_attention_kernel<D, TW, PALLAS, MODE><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, in_ps, lw, lb, out, out_ps, H, W, cb, h_sp, w_sp, scale);
  return cudaGetLastError();
}

// The float32 instances: one (window, head) per CTA on attn_tile::tile_f32.
// Four CTAs an SM is the register budget (128 a thread: the 8 x d/4 product
// block and its reduce-scatter fit without spilling; left free, ptxas has
// picked 96 and spilled at d = 24).
template <int D>
__global__ void __launch_bounds__(WARPS * 32, 4)
stripe_attention_f32_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                            const float* __restrict__ vp, size_t in_ps,
                            const float* __restrict__ lepe_w, const float* __restrict__ lepe_b,
                            float* __restrict__ out, size_t out_ps, int H, int W, int cb,
                            int h_sp, int w_sp, float scale) {
  extern __shared__ __align__(128) float smem[];
  attn_tile::tile_f32<D>(qp, kp, vp, in_ps, lepe_w, lepe_b, out, out_ps, H, W, cb, h_sp, w_sp,
                         scale, blockIdx.x, blockIdx.y, smem);
}

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v, size_t in_ps,
                       const float* lw, const float* lb, float* out, size_t out_ps, int B,
                       int H, int W, int cb, int heads, int h_sp, int w_sp, float scale,
                       cudaStream_t stream) {
  const size_t smem = attn_tile::smem_bytes_f32<D>(h_sp * w_sp);
  cudaError_t err = allow_smem(stripe_attention_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (H / h_sp) * (W / w_sp), heads);
  stripe_attention_f32_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, in_ps, lw, lb, out, out_ps, H, W, cb, h_sp, w_sp, scale);
  return cudaGetLastError();
}

int dispatch_f32(const float* q, const float* k, const float* v, size_t in_ps, const float* lw,
                 const float* lb, float* out, size_t out_ps, int B, int H, int W, int cb,
                 int heads, int h_sp, int w_sp, float scale, cudaStream_t s) {
  switch (cb / heads) {
    case 16: return (int)launch_f32<16>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    case 24: return (int)launch_f32<24>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    case 32: return (int)launch_f32<32>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TW, bool PALLAS, int MODE = attn_tile::FULL>
int dispatch(const bf16* q, const bf16* k, const bf16* v, size_t in_ps, const TW* lw,
             const TW* lb, bf16* out, size_t out_ps, int B, int H, int W, int cb,
             int heads, int h_sp, int w_sp, float scale, cudaStream_t s) {
  switch (cb / heads) {
    case 16: return (int)launch<16, TW, PALLAS, MODE>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    case 24: return (int)launch<24, TW, PALLAS, MODE>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    case 32: return (int)launch<32, TW, PALLAS, MODE>(q, k, v, in_ps, lw, lb, out, out_ps, B, H, W, cb, heads, h_sp, w_sp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: (B, H, W, 3C) bf16; lepe_w: (9, cb) bf16 (tap-major, tap = di·3 + dj);
// lepe_b: (cb,) bf16; out: (B, H, W, C) bf16, written at channels
// [ch_off, ch_off + cb). head_dim = cb / heads must be 16, 24 or 32 (the
// head dims of the repo's configs: 32 at tiny-224, 24 at base-384, 16 in
// the narrow test geometries). qkv + ch_off is 16-byte aligned and C % 8 ==
// 0 (the tile copies 16-byte chunks; checked by the wrapper).
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
// float32; out: (B, H, W, cb) bf16, contiguous. Head dims as above; q, k
// and v 16-byte aligned and pix_stride % 8 == 0 (checked by the wrapper).
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

// The float32 instances (TPU.COMPUTE_DTYPE float32) of the two entries
// above: every tensor float32, LePE taps (9, cb) and bias (cb,) float32;
// out = P·V + (conv(V, w) + b), nothing rounded (at float32 the two
// entries' roundings coincide). Head dims as above; the pointers 16-byte
// aligned, C % 4 == 0 and ch_off % 4 == 0, pix_stride % 4 == 0 (checked by
// the wrapper).
CSWIN_API int cswin_stripe_attention_f32(const void* qkv, const void* lepe_w,
                                         const void* lepe_b, void* out, int B, int H, int W,
                                         int C, int ch_off, int cb, int heads, int h_sp,
                                         int w_sp, float scale, void* stream) {
  const float* q = (const float*)qkv + ch_off;
  return dispatch_f32(q, q + C, q + 2 * C, 3 * (size_t)C, (const float*)lepe_w,
                      (const float*)lepe_b, (float*)out + ch_off, C, B, H, W, cb, heads,
                      h_sp, w_sp, scale, (cudaStream_t)stream);
}

CSWIN_API int cswin_cswin_attention_f32(const void* q, const void* k, const void* v,
                                        long long pix_stride, const void* lepe_w,
                                        const void* lepe_b, void* out, int B, int H, int W,
                                        int cb, int heads, int h_sp, int w_sp, float scale,
                                        void* stream) {
  return dispatch_f32((const float*)q, (const float*)k, (const float*)v, (size_t)pix_stride,
                      (const float*)lepe_w, (const float*)lepe_b, (float*)out, cb, B, H, W,
                      cb, heads, h_sp, w_sp, scale, (cudaStream_t)stream);
}

// The float32 tile's dynamic shared memory at a window of L tokens and head
// dim d (16, 24 or 32), or -1: what kernels.py::attention_f32_smem mirrors.
CSWIN_API long long cswin_stripe_attention_f32_smem(int L, int d) {
  switch (d) {
    case 16: return (long long)attn_tile::smem_bytes_f32<16>(L);
    case 24: return (long long)attn_tile::smem_bytes_f32<24>(L);
    case 32: return (long long)attn_tile::smem_bytes_f32<32>(L);
    default: return -1;
  }
}

// q, k, v, out as for cswin_cswin_attention; no LePE. mode 1: attention,
// 2: the products with the softmax stubbed, 3: the copy floor, 4: the first
// product and the softmax, 5: the staging (the modes of attention_tile.cuh).
// Head dims as above.
CSWIN_API int cswin_window_attention(const void* q, const void* k, const void* v,
                                     long long pix_stride, void* out, int B, int H, int W,
                                     int cb, int heads, int h_sp, int w_sp, float scale,
                                     int mode, void* stream) {
#define CSWIN_WINDOW_ATTENTION(MODE)                                                    \
  dispatch<float, true, MODE>((const bf16*)q, (const bf16*)k, (const bf16*)v,            \
                              (size_t)pix_stride, nullptr, nullptr, (bf16*)out, cb, B, H, \
                              W, cb, heads, h_sp, w_sp, scale, (cudaStream_t)stream)
  switch (mode) {
    case attn_tile::NO_LEPE: return CSWIN_WINDOW_ATTENTION(attn_tile::NO_LEPE);
    case attn_tile::NO_SOFTMAX: return CSWIN_WINDOW_ATTENTION(attn_tile::NO_SOFTMAX);
    case attn_tile::COPY: return CSWIN_WINDOW_ATTENTION(attn_tile::COPY);
    case attn_tile::SOFTMAX: return CSWIN_WINDOW_ATTENTION(attn_tile::SOFTMAX);
    case attn_tile::STAGE: return CSWIN_WINDOW_ATTENTION(attn_tile::STAGE);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CSWIN_WINDOW_ATTENTION
}
