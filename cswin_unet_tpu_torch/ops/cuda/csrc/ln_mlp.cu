// The MLP half of a CSWin block in one launch, the 4C-wide hidden never
// written to global memory:
//
//   out = x + fc2(act(fc1(LN(x))))            rows of width C = 64, hidden 256
//
// rounding to bf16 where the block's composition rounds (cswin_block.py
// _layernorm / _dot, :84-96): the LN output, the fc1 output (with its bias),
// the activation, the fc2 output (with its bias), then the residual sum.
// Compile-time modes, each a kernel the TPU experiments priced:
//   ACT   0: exact erf GELU; 1: the clamp v · min(max(v + 0.5, 0), 1)
//         (a stand-in of the same shape without the erf)
//   LN    off: fc1 reads x as it is
//   FOLD  no fc2 and no residual: the activated hidden, unrounded, summed
//         over its four C-wide groups in float32, rounded once
//
// Replaces: the MLP kernels of scripts/exp_pack.py:60 (k64, k64g2, k64mm,
//   k128), scripts/exp_lane.py:67 (k_mlp_u, k_mlp_p) and scripts/exp_vpu.py:43
//   (k_gelu, k_gelu_tanhless). The lane-paired forms there (two pixels or two
//   images side by side on 128 lanes, block-diagonal weights) compute this
//   function of the unpaired view of the same bytes.
// Bound on the H100: operations, narrowly. 2·2·64·256 tensor-core flops a
//   row against 256 bytes moved (x read, out written) is 256 flops a byte,
//   just under the card's ridge of ~295, but LN and the activation add
//   float32 work (~10 operations on each of 256 hidden values a row) at a
//   fifteenth of the tensor cores' rate: at 401,408 rows 0.045 ms of
//   operations against 0.031 ms of bytes. The chain of three launches (LN,
//   fc1 + GELU, fc2 + residual) moves the hidden to memory and back, 6.5x
//   the bytes.
// Design: a CTA of four warps takes 64 rows and normalises them into shared
//   memory (layernorm_row.cuh's rows, 16 a step), then the CTA walks the hidden in
//   four chunks of 64: fc1 chunk (bf16 WMMA 16x16x16, four warps of 32x32 as
//   the GEMM tile's) -> float32 tile in shared memory -> bias, rounding,
//   activation -> bf16 chunk in shared memory -> fc2 partial product into
//   float32 accumulator fragments that stay in registers over the chunks.
//   The weights (2 x 64 x 256 bf16 = 64 KB) are streamed by chunk through
//   one 9 KB buffer, first the fc1 chunk, then the fc2 chunk, instead of
//   opting into 64 KB more shared memory: they come from L2, where every
//   CTA finds them, and 45 KB a CTA keeps 5 CTAs on an SM to hide the
//   unpipelined loads. No cp.async / TMA / wgmma: first right, then fast.

#include <mma.h>

#include "gemm_tile.cuh"
#include "layernorm_row.cuh"

namespace {

using namespace nvcuda;

constexpr int C = 64, HID = 256, BM = 64, HC = 64, PAD = 8, CPAD = 4, THREADS = 128;
constexpr int PER_THREAD = BM * HC / THREADS;  // epilogue elements a thread

struct __align__(128) Smem {
  bf16 Xn[BM][C + PAD];    // the rows as fc1 reads them (normalised)
  bf16 Ws[HC][C + PAD];    // one 64 x 64 chunk of fc1_w, then of fc2_w
  bf16 Hs[BM][HC + PAD];   // the activated hidden chunk
  float Cs[BM][HC + CPAD];  // a product's float32 tile on its way to an epilogue
};

template <int ACT>
__device__ __forceinline__ float activation(float v) {
  if constexpr (ACT == 0) return gemm_tile::gelu_erf(v);
  return v * fminf(fmaxf(v + 0.5f, 0.f), 1.f);
}

// 64 rows of 64 bf16 values, `ld` elements apart in global memory, into Ws.
__device__ __forceinline__ void load_chunk(bf16 (*Ws)[C + PAD], const bf16* __restrict__ src,
                                           int ld, int tid) {
  constexpr int CHUNKS = C / 8;  // 16-byte chunks per row
  for (int i = tid; i < HC * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(&Ws[r][c]) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// acc (2x2 fragments of this warp's 32x32) += A[64 x 64] · Bsᵀ, both in
// shared memory with padded rows; Bs holds B as (n, k), read column-major.
__device__ __forceinline__ void mma_64(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[2][2],
    bf16 (*A)[C + PAD], bf16 (*Bs)[C + PAD], int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < C; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &A[wm * 32 + i * 16][kk], C + PAD);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[wn * 32 + j * 16][kk], C + PAD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_tile(
    float (*Cs)[HC + CPAD],
    const wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[2][2], int wm,
    int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j],
                              HC + CPAD, wmma::mem_row_major);
}

template <int ACT, bool LN, bool FOLD>
__global__ void __launch_bounds__(THREADS)
ln_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ nw,
              const float* __restrict__ nb, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const float* __restrict__ b2, bf16* __restrict__ out, int M, float eps) {
  static_assert(HC == C, "the weight chunks and the tiles share one shape");
  __shared__ Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // 2x2 warps of 32x32
  const int m0 = blockIdx.x * BM;

  if constexpr (LN)
    ln_row::rows_any(x + (size_t)m0 * C, C, nw, nb, &sm.Xn[0][0], C + PAD, min(BM, M - m0), C,
                     eps, THREADS, 0, 1);
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int gm = m0 + r;
    if (gm >= M) {
      for (int c = lane; c < C; c += 32) sm.Xn[r][c] = f2bf(0.f);
    } else if (!LN) {
      for (int c = lane; c < C; c += 32) sm.Xn[r][c] = x[(size_t)gm * C + c];
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc2[i][j], 0.f);
  float fold[PER_THREAD];
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) fold[t] = 0.f;

  for (int h = 0; h < HID / HC; ++h) {
    // fc1_w is (HID, C): the chunk's 64 output rows, all of K = C.
    load_chunk(sm.Ws, w1 + (size_t)h * HC * C, C, tid);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc1[i][j], 0.f);
    mma_64(acc1, sm.Xn, sm.Ws, wm, wn);
    store_tile(sm.Cs, acc1, wm, wn);
    __syncthreads();

    // Unrolled in full only where fold[] must stay in registers: unrolling
    // the 32 activations of the other mode cost it 255 registers and spills
    // (2 CTAs an SM, 0.81 ms at 401,408 rows on an H100 at 700 W); by twos
    // it takes 96 (5 CTAs an SM, 0.51 ms). A cap of 128 registers on every
    // mode made this one slower (0.57 ms) and the fold modes spill.
#pragma unroll(FOLD ? PER_THREAD : 2)
    for (int t = 0; t < PER_THREAD; ++t) {
      const int i = tid + t * THREADS;
      const int r = i / HC, c = i % HC;
      const float pre = round_bf16(sm.Cs[r][c] + (b1 != nullptr ? b1[h * HC + c] : 0.f));
      const float a = activation<ACT>(pre);
      if constexpr (FOLD) fold[t] += a;
      else sm.Hs[r][c] = f2bf(a);
    }
    if constexpr (!FOLD) {
      // fc2_w is (C, HID): all 64 output rows, the chunk's 64 columns of K.
      load_chunk(sm.Ws, w2 + (size_t)h * HC, HID, tid);
      __syncthreads();
      mma_64(acc2, sm.Hs, sm.Ws, wm, wn);
    }
    __syncthreads();  // the next chunk restages Ws, Cs and Hs
  }

  if constexpr (!FOLD) {
    store_tile(sm.Cs, acc2, wm, wn);
    __syncthreads();
  }
#pragma unroll(FOLD ? PER_THREAD : 4)
  for (int t = 0; t < PER_THREAD; ++t) {
    const int i = tid + t * THREADS;
    const int r = i / C, c = i % C;
    const int gm = m0 + r;
    if (gm >= M) continue;
    const size_t o = (size_t)gm * C + c;
    if constexpr (FOLD) {
      out[o] = f2bf(fold[t]);
    } else {
      const float branch = round_bf16(sm.Cs[r][c] + (b2 != nullptr ? b2[c] : 0.f));
      out[o] = f2bf(bf2f(x[o]) + branch);
    }
  }
}

template <int ACT, bool LN, bool FOLD>
int launch(const void* x, const void* nw, const void* nb, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int M, float eps, void* stream) {
  ln_mlp_kernel<ACT, LN, FOLD><<<(M + BM - 1) / BM, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)nw, (const float*)nb, (const bf16*)w1,
      (const float*)b1, (const bf16*)w2, (const float*)b2, (bf16*)out, M, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (M, C) bf16, contiguous; nw, nb: (C,) float32 (unread with ln = 0);
// w1: (hidden, C) bf16 and w2: (C, hidden) bf16, the torch Linear layout
// (w2 unread with fold = 1); b1: (hidden,), b2: (C,) float32 or null.
// act 0: erf GELU, 1: clamp. Only C = 64 with hidden = 256 is compiled (the
// stage-1 width of tiny-224); anything else returns cudaErrorInvalidValue.
// Requires 16-byte aligned w1 and w2 (checked by the wrapper).
CSWIN_API int cswin_ln_mlp(const void* x, const void* nw, const void* nb, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, int M,
                           int channels, int hidden, float eps, int act, int ln, int fold,
                           void* stream) {
  if (channels != C || hidden != HID || M < 1 || act < 0 || act > 1)
    return (int)cudaErrorInvalidValue;
#define CSWIN_LN_MLP(ACT, LN, FOLD) \
  launch<ACT, LN, FOLD>(x, nw, nb, w1, b1, w2, b2, out, M, eps, stream)
  switch (act * 4 + (ln != 0) * 2 + (fold != 0)) {
    case 0: return CSWIN_LN_MLP(0, false, false);
    case 1: return CSWIN_LN_MLP(0, false, true);
    case 2: return CSWIN_LN_MLP(0, true, false);
    case 3: return CSWIN_LN_MLP(0, true, true);
    case 4: return CSWIN_LN_MLP(1, false, false);
    case 5: return CSWIN_LN_MLP(1, false, true);
    case 6: return CSWIN_LN_MLP(1, true, false);
    default: return CSWIN_LN_MLP(1, true, true);
  }
#undef CSWIN_LN_MLP
}
