// Tiled bf16 GEMMs of the CSWin block, forward and backward, float32
// accumulation.
//
// cswin_gemm: out = epilogue(A' · Bᵀ + bias), bf16 out. A is (M, K)
// row-major activations; B is (N, K) row-major, the torch Linear weight
// layout (the backward's dX products pass the pre-transposed weight). A' is
// A, or A with row m scaled by a_scale[m / rows_per_sample] and rounded to
// bf16 as it is loaded (the drop-path multiplier of a dX product).
// Epilogues:
//   0  bias                     (qkv; CARAFE down conv | classes GEMM; dX)
//   1  bias + residual add      (proj, fc2): out = res + bf16(acc + bias),
//      or with a per-sample drop-path multiplier dp = out_scale[m / rpsample]
//      out = res + bf16(bf16(acc + bias) · dp)
//   2  bias + exact erf GELU    (fc1), applied to the float32 accumulator;
//      with `aux` it also writes the pre-activation bf16(acc + bias) there
//      (training keeps it for the backward)
//   3  GELU backward            (fc2 dX): out = acc · (Φ(h) + h·φ(h)), h
//      read from `aux`, the saved fc1 pre-activation
//
// cswin_gemm_wgrad: weight gradient dW = dY'ᵀ · X over M rows, split over M
// into `splits` chunks that each write a float32 partial (splits, N, K); the
// CTAs of the first K tile also write the bias-gradient partials Σ dY'
// (splits, N). dY' is dY with the same optional per-sample row scale.
//
// Replaces: the matrix products inside the fused TPU block and CARAFE
//   kernels — cswin_unet_tpu/ops/pallas/cswin_block.py::_block_kernel_xt /
//   _block_kernel (qkv, proj, fc1, fc2 via _dot) and
//   cswin_unet_tpu/ops/pallas/carafe_tail.py::_kernel (down conv, x·W_y9) —
//   and those of the block backward ::_block_bwd_kernel_xt (the dX dots
//   against pre-transposed weights, _gelu_bwd, the per-program _wgrad
//   partials and bias sums).
// Bound on the H100: at the block's shapes (K = C <= 2048, N <= 4C) these
//   are tall-skinny products with ~K/2 flops per byte of A — below the
//   card's ~295 flop/byte ridge for K < 512, so mostly bandwidth and
//   latency bound, with the tensor cores far from saturated. The weight
//   gradient contracts over M = B·H·W (75,264 rows at stage 1, bs 24) into
//   a tiny (N, K) output, so it must split M to fill 132 SMs.
// Design: the forward / dX tile (gemm_tile.cuh, shared with the persistent
//   block kernels block_pair.cu and block_one.cu) is 64x64 per 128-thread
//   block, four warps of 32x32 on mma.sync m16n8k16 (bf16 in, float32
//   accumulators) fed by a three-stage ring of 16-byte cp.async copies 32
//   deep, so the next k-blocks are in flight during the products; the
//   epilogue runs on the accumulator registers, so bias, residual,
//   drop-path, GELU and its derivative cost no extra pass over memory and
//   no staging tile. The grid is one-dimensional, M tiles outer and N tiles
//   inner: the N tiles that share an A tile run side by side and read it
//   from L2, and M may exceed 65535 tiles. The weight gradient is 64x64
//   tiles of bf16 WMMA 16x16x16 over 32-row steps of M
//   through padded shared memory with 16-byte loads: it reads dY tiles
//   m-major and feeds them to WMMA as a column-major A (that is dYᵀ)
//   without a transpose pass, and sums the bias gradient from the same
//   shared tile.

#include <mma.h>

#include "gemm_tile.cuh"

using namespace nvcuda;

namespace {

using gemm_tile::THREADS;

// Eight bf16 values from a 16-byte chunk, each scaled by s and rounded back.
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int t = 0; t < 8; ++t) e[t] = f2bf(bf2f(e[t]) * s);
  return v;
}

// One output tile per CTA: blockIdx.x walks the tiles, N inner (tn tiles
// an M tile).
template <int EPI, bool A_SCALED, bool EXTRA>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const float* __restrict__ bias, const bf16* __restrict__ res,
            bf16* __restrict__ aux, const float* __restrict__ a_scale,
            const float* __restrict__ out_scale, bf16* __restrict__ out, int M,
            int N, int K, int rows_per_sample, int tn) {
  __shared__ gemm_tile::Smem sm;
  const int t = blockIdx.x;
  gemm_tile::tile<EPI, A_SCALED, EXTRA>(A, B, bias, res, aux, a_scale, out_scale, out,
                                        M, N, K, rows_per_sample, t / tn * gemm_tile::BM,
                                        t % tn * gemm_tile::BN, sm);
}

// The weight gradient's tile: BM x BN of (K, N), WK rows of M a step.
constexpr int BM = 64, BN = 64, WK = 32, PAD = 8, CPAD = 4;

__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const bf16* __restrict__ X, const bf16* __restrict__ dY,
             const float* __restrict__ dy_scale, float* __restrict__ dw_part,
             float* __restrict__ db_part, int M, int N, int K, int rows_per_sample,
             int chunk) {
  __shared__ __align__(128) bf16 Ds[WK][BN + PAD];   // dY tile, m-major
  __shared__ __align__(128) bf16 Xs[WK][BM + PAD];   // X tile, m-major
  __shared__ __align__(128) float Cs[BN][BM + CPAD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wn = warp >> 1, wk = warp & 1;  // 2x2 warps of 32x32 over (N, K)
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int m_begin = split * chunk;
  const int m_end = min(M, m_begin + chunk);
  const bool do_bias = db_part != nullptr && blockIdx.x == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  float bsum = 0.f;

  constexpr int CHUNKS = BN / 8;  // 16-byte chunks per tile row (BN == BM)
  for (int m0 = m_begin; m0 < m_end; m0 += WK) {
    for (int i = tid; i < WK * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int gm = m0 + r;
      uint4 d = make_uint4(0u, 0u, 0u, 0u), x = make_uint4(0u, 0u, 0u, 0u);
      if (gm < m_end) {
        if (n0 + c < N) {
          d = *reinterpret_cast<const uint4*>(dY + (size_t)gm * N + n0 + c);
          if (dy_scale != nullptr) d = scale8(d, dy_scale[gm / rows_per_sample]);
        }
        if (k0 + c < K) x = *reinterpret_cast<const uint4*>(X + (size_t)gm * K + k0 + c);
      }
      *reinterpret_cast<uint4*>(&Ds[r][c]) = d;
      *reinterpret_cast<uint4*>(&Xs[r][c]) = x;
    }
    __syncthreads();
    if (do_bias && tid < BN) {
#pragma unroll 8
      for (int r = 0; r < WK; ++r) bsum += bf2f(Ds[r][tid]);
    }
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      // A = dYᵀ: element (n, m) sits at Ds[m][n], a column-major view.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &Ds[kk][wn * 32 + i * 16], BN + PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Xs[kk][wk * 32 + j * 16], BM + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wn * 32 + i * 16][wk * 32 + j * 16], acc[i][j],
                              BM + CPAD, wmma::mem_row_major);
  __syncthreads();

  float* part = dw_part + (size_t)split * N * K;
  for (int i = tid; i < BN * BM; i += THREADS) {
    const int r = i / BM, c = i % BM;
    const int gn = n0 + r, gk = k0 + c;
    if (gn < N && gk < K) part[(size_t)gn * K + gk] = Cs[r][c];
  }
  if (do_bias && tid < BN && n0 + tid < N) db_part[(size_t)split * N + n0 + tid] = bsum;
}

template <int EPI, bool A_SCALED, bool EXTRA>
int launch_gemm(const void* A, const void* B, const void* bias, const void* res,
                void* aux, const void* a_scale, const void* out_scale, void* out,
                int M, int N, int K, int rows_per_sample, void* stream) {
  const int tn = (N + gemm_tile::BN - 1) / gemm_tile::BN;
  const long long tiles = (long long)((M + gemm_tile::BM - 1) / gemm_tile::BM) * tn;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gemm_kernel<EPI, A_SCALED, EXTRA><<<(unsigned)tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)A, (const bf16*)B, (const float*)bias, (const bf16*)res,
      (bf16*)aux, (const float*)a_scale, (const float*)out_scale, (bf16*)out, M,
      N, K, rows_per_sample, tn);
  return (int)cudaGetLastError();
}

}  // namespace

// A, B, res, aux, out: bf16; bias, a_scale, out_scale: float32 or null.
// res is read by epilogue 1, aux written by epilogue 2 (if not null) and read
// by epilogue 3; a_scale (epilogues 0 and 3) and out_scale (epilogue 1) are
// per-sample (row / rows_per_sample). Other combinations return
// cudaErrorInvalidValue. Requires K % 8 == 0 and 16-byte aligned A and B
// (checked by the wrapper); at most 2^31 - 1 output tiles of 64 x 64.
CSWIN_API int cswin_gemm(const void* A, const void* B, const void* bias,
                         const void* res, void* aux, const void* a_scale,
                         const void* out_scale, void* out, int M, int N, int K,
                         int rows_per_sample, int epilogue, void* stream) {
#define CSWIN_GEMM(EPI, AS, EX)                                                   \
  launch_gemm<EPI, AS, EX>(A, B, bias, res, aux, a_scale, out_scale, out, M, N, K, \
                           rows_per_sample, stream)
  const bool as = a_scale != nullptr;
  switch (epilogue) {
    case 0: return as ? CSWIN_GEMM(0, true, false) : CSWIN_GEMM(0, false, false);
    case 1:
      if (as) break;
      return out_scale != nullptr ? CSWIN_GEMM(1, false, true) : CSWIN_GEMM(1, false, false);
    case 2:
      if (as) break;
      return aux != nullptr ? CSWIN_GEMM(2, false, true) : CSWIN_GEMM(2, false, false);
    case 3: return as ? CSWIN_GEMM(3, true, false) : CSWIN_GEMM(3, false, false);
  }
#undef CSWIN_GEMM
  return (int)cudaErrorInvalidValue;
}

// X: (M, K) bf16; dY: (M, N) bf16; dy_scale: per-sample float32 or null;
// dw_part: (splits, N, K) float32; db_part: (splits, N) float32 or null.
// Split s reduces rows [s·chunk, min(M, (s+1)·chunk)). Requires N % 8 == 0,
// K % 8 == 0, chunk % 32 == 0 and 16-byte aligned X and dY.
CSWIN_API int cswin_gemm_wgrad(const void* X, const void* dY, const void* dy_scale,
                               void* dw_part, void* db_part, int M, int N, int K,
                               int rows_per_sample, int chunk, int splits,
                               void* stream) {
  const dim3 grid((K + BM - 1) / BM, (N + BN - 1) / BN, splits);
  wgrad_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)X, (const bf16*)dY, (const float*)dy_scale, (float*)dw_part,
      (float*)db_part, M, N, K, rows_per_sample, chunk);
  return (int)cudaGetLastError();
}
