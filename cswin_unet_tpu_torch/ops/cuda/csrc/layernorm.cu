// LayerNorm over the channel axis of a (rows, C) bf16 tensor, forward and
// backward: LN1 and LN2 of the CSWin block chain.
//
// Forward: float32 statistics, bf16 out.
// Backward, per row, with float32 statistics recomputed from x:
//   dx = res + rstd·(dŷ − mean(dŷ) − x̂·mean(dŷ·x̂)),   dŷ = dy·γ
// plus per-CTA float32 partials of dγ = Σ dy·x̂ and dβ = Σ dy over the CTA's
// rows (the wrapper sums them). `res` is the residual stream's gradient
// that the block adds here (dout for LN2, dx1 for LN1), or null.
//
// Replaces: the two in-kernel LayerNorms of the fused TPU block,
//   cswin_unet_tpu/ops/pallas/cswin_block.py::_block_kernel_xt /
//   _block_kernel (via _layernorm), reference composition composed_block;
//   and their backward in ::_block_bwd_kernel_xt (via _ln_bwd, :586-601).
// Bound on the H100: memory bandwidth — the forward reads and writes each
//   element once (2 + 2 bytes) and does ~8 flops on it; the backward reads
//   x, dy and res and writes dx (8 bytes) for ~15 flops.
// Design: one warp per row, two-pass mean / variance as the reference
//   computes them. The forward re-reads the row from L1 rather than holding
//   it in registers, so one kernel serves every C. The backward holds the
//   row's x̂ and dŷ in registers (C <= 512, C % 32 == 0: at most 16 values a
//   lane), keeps each lane's dγ / dβ sums in registers across the CTA's rows
//   and reduces them across the CTA's 8 warps through shared memory once.
//   The forward row's body lives in layernorm_row.cuh, shared with the
//   persistent pair kernel (block_pair.cu).

#include "layernorm_row.cuh"

namespace {

constexpr int LN_WARPS = 8;
constexpr int LN_MAXJ = 16;  // channels per lane in the backward: C <= 512

}  // namespace

__global__ void __launch_bounds__(256)
layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, bf16* __restrict__ y, int rows,
                 int C, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // whole warp leaves together
  ln_row::row(x, w, b, y, row, C, eps, threadIdx.x & 31);
}

__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     const float* __restrict__ w, const bf16* __restrict__ res,
                     bf16* __restrict__ dx, float* __restrict__ dw_part,
                     float* __restrict__ db_part, int rows, int C, int rows_per_cta,
                     float eps) {
  __shared__ float red_w[LN_WARPS][LN_MAXJ * 32];
  __shared__ float red_b[LN_WARPS][LN_MAXJ * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int J = C / 32;
  const int row0 = blockIdx.x * rows_per_cta;
  const int row_end = min(rows, row0 + rows_per_cta);

  float gw[LN_MAXJ], gb[LN_MAXJ];
#pragma unroll
  for (int j = 0; j < LN_MAXJ; ++j) gw[j] = gb[j] = 0.f;

  for (int row = row0 + warp; row < row_end; row += LN_WARPS) {
    const size_t base = (size_t)row * C + lane;
    float xh[LN_MAXJ], dh[LN_MAXJ];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAXJ; ++j)
      if (j < J) {
        xh[j] = bf2f(x[base + 32 * j]);
        s += xh[j];
      }
    const float mu = warp_sum(s) / C;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAXJ; ++j)
      if (j < J) {
        const float d = xh[j] - mu;
        v += d * d;
      }
    const float rstd = rsqrtf(warp_sum(v) / C + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAXJ; ++j)
      if (j < J) {
        xh[j] = (xh[j] - mu) * rstd;
        const float g = bf2f(dy[base + 32 * j]);
        gw[j] += g * xh[j];
        gb[j] += g;
        dh[j] = g * w[lane + 32 * j];
        m1 += dh[j];
        m2 += dh[j] * xh[j];
      }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
#pragma unroll
    for (int j = 0; j < LN_MAXJ; ++j)
      if (j < J) {
        float o = rstd * (dh[j] - m1 - xh[j] * m2);
        if (res != nullptr) o += bf2f(res[base + 32 * j]);
        dx[base + 32 * j] = f2bf(o);
      }
  }

#pragma unroll
  for (int j = 0; j < LN_MAXJ; ++j)
    if (j < J) {
      red_w[warp][lane + 32 * j] = gw[j];
      red_b[warp][lane + 32 * j] = gb[j];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < LN_WARPS; ++k) {
      sw += red_w[k][c];
      sb += red_b[k][c];
    }
    dw_part[(size_t)blockIdx.x * C + c] = sw;
    db_part[(size_t)blockIdx.x * C + c] = sb;
  }
}

CSWIN_API int cswin_layernorm(const void* x, const void* w, const void* b,
                              void* y, int rows, int C, float eps,
                              void* stream) {
  const int threads = 256;  // 8 rows per block
  const int blocks = (rows + 7) / 8;
  layernorm_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)w, (const float*)b, (bf16*)y, rows, C, eps);
  return (int)cudaGetLastError();
}

// x, dy, res, dx: (rows, C) bf16 (res may be null); w: (C,) float32;
// dw_part, db_part: (ceil(rows / rows_per_cta), C) float32. Requires
// C % 32 == 0 and C <= 512 (checked by the wrapper).
CSWIN_API int cswin_layernorm_bwd(const void* x, const void* dy, const void* w,
                                  const void* res, void* dx, void* dw_part,
                                  void* db_part, int rows, int C, int rows_per_cta,
                                  float eps, void* stream) {
  if (C % 32 || C > LN_MAXJ * 32) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + rows_per_cta - 1) / rows_per_cta;
  layernorm_bwd_kernel<<<blocks, LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)dy, (const float*)w, (const bf16*)res,
      (bf16*)dx, (float*)dw_part, (float*)db_part, rows, C, rows_per_cta, eps);
  return (int)cudaGetLastError();
}
