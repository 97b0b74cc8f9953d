// The float32 GEMMs of the CSWin block (TPU.COMPUTE_DTYPE float32), forward
// and backward, FFMA on the CUDA cores (no tensor-core format keeps float32's
// products: TF32 drops 13 bits of each operand).
//
// cswin_gemm_f32: out = epilogue(A' · Bᵀ + bias), float32 throughout, with
// gemm.cu's operands, epilogues 0-3, operand scale and dropout instances and
// nothing rounded: epilogue 1 out = res + D(acc + bias)·dp, epilogue 2
// aux = acc + bias, out = D(GELU(acc + bias)), epilogue 3 out =
// D(acc)·(Φ(h) + h·φ(h)), A' = D(A·a_scale), a kept value v / kd.
// cswin_gemm_wgrad_f32: dW = dY'ᵀ · X over M rows and db = Σ dY', dY' dY
// times its row's scale and masked as epilogue 3 masks it.
//
// Replaces: as gemm.cu, the matrix products inside the fused TPU block and
//   CARAFE kernels (cswin_unet_tpu/ops/pallas/cswin_block.py::
//   _block_kernel_xt, _dot; carafe_tail.py::_kernel) and those of the block
//   backward (_block_bwd_kernel_xt: the dX dots, _gelu_bwd, _wgrad and the
//   bias sums), at float32.
// Bound on the H100: 67 TFLOP/s of FFMA against 3.35 TB/s is a ridge of
//   ~20 operations a byte. The forward and dX products do 2·K / 12 to
//   2·K / 8 operations a byte of their operands: above the ridge from
//   K ~ 128, so at the block's shapes (K = C to 4C) mostly the FFMA rate.
//   The weight gradient contracts M = B·H·W rows into a (N, K) tile: 2·N·K /
//   (4·(N + K)) operations a byte, bound by the FFMA rate from C = 64 on.
//
// Design, forward and dX (gemm_f32_kernel): gemm_f32_tile.cuh, one output
//   tile a CTA.
// Design, weight gradient (wgrad_f32_kernel): grid (splits, tiles) as
//   gemm.cu's wgrad_kernel, with its own plan (kernels.wgrad_f32_plan:
//   splits sized by a CTA's FFMA work against the cross-split sums) and the
//   same fixed-order sums (wgrad_sum.cuh). Both operands are m-major, so a
//   ring stage of MS rows is MS rank-one updates of the BN x BK tile: thread
//   (tn, tk) = (tid / (BK/8), tid % (BK/8)) owns dW rows 4tn..4tn+3 and
//   BN/2+4tn.. and columns 4tk.. and BK/2+4tk.. (8 x 8), and a row m at a
//   time reads two 16-byte words of dY' (broadcast across the threads of
//   one tn) and two of X (consecutive words) for 64 FFMAs. dY' is scaled
//   and masked once in the ring as its rows land; the same pass, spread
//   over all threads, sums the stage's rows into db (k0 = 0 tiles only).

#include "gemm_f32_tile.cuh"
#include "wgrad_sum.cuh"

namespace {

template <int BM, int BN, bool KN, int EPI, bool EXTRA, bool A_SCALED, bool DROP>
__global__ void __launch_bounds__(BM * BN / (8 * gemm_f32::TN))
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ aux, const float* __restrict__ a_scale,
                const float* __restrict__ out_scale, float* __restrict__ out, int M, int N,
                int K, int rows_per_sample, int tn, DropArgs drop) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  gemm_f32::tile<BM, BN, KN, EPI, EXTRA, A_SCALED, DROP>(
      A, B, bias, res, aux, a_scale, out_scale, out, M, N, K, rows_per_sample,
      blockIdx.x / tn * BM, blockIdx.x % tn * BN, drop,
      *reinterpret_cast<gemm_f32::Smem<BM, BN, KN>*>(smem_raw));
}

// The float32 GEMM tiles the planner picks from (kernels.gemm_f32_plan):
// BM x BN outputs a CTA.
template <int BM, int BN>
struct Tile {
  static constexpr int bm = BM, bn = BN;
};

template <typename T, bool KN, int EPI, bool EXTRA, bool A_SCALED = false, bool DROP = false>
int launch_gemm_f32(const void* A, const void* B, const void* bias, const void* res,
                    void* aux, const void* a_scale, const void* out_scale, void* out, int M,
                    int N, int K, int rows_per_sample, void* stream,
                    const DropArgs& drop = DropArgs()) {
  const int tn = (N + T::bn - 1) / T::bn;
  const long long tiles = (long long)((M + T::bm - 1) / T::bm) * tn;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto kernel = gemm_f32_kernel<T::bm, T::bn, KN, EPI, EXTRA, A_SCALED, DROP>;
  constexpr size_t smem = sizeof(gemm_f32::Smem<T::bm, T::bn, KN>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tiles, T::bm * T::bn / (8 * gemm_f32::TN), smem, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)B, (const float*)bias, (const float*)res, (float*)aux,
      (const float*)a_scale, (const float*)out_scale, (float*)out, M, N, K, rows_per_sample,
      tn, drop);
  return (int)cudaGetLastError();
}

// The instance of one tile for an epilogue, its operand scale, EXTRA and
// dropout, as cswin_gemm chooses them; with KN (the dX product) epilogues 0
// and 3 only.
template <typename T, bool KN>
int gemm_f32_entry(const void* A, const void* B, const void* bias, const void* res,
                   void* aux, const void* a_scale, const void* out_scale, void* out, int M,
                   int N, int K, int rows_per_sample, int epilogue, const void* key_a,
                   const void* key_out, long long row0, float kd, unsigned thr,
                   void* stream) {
  const bool as = a_scale != nullptr;
  if (key_a != nullptr || key_out != nullptr) {
    if (N % 8 || epilogue < 1 || epilogue > 3 || (key_a != nullptr && epilogue != 3))
      return (int)cudaErrorInvalidValue;
    DropArgs drop;
    drop.key_a = (const unsigned long long*)key_a;
    drop.key_out = (const unsigned long long*)key_out;
    drop.row0 = row0;
    drop.kd = kd;
    drop.thr = thr;
#define CSWIN_GEMM_F32_DROP(EPI, EX, AS)                                                   \
  launch_gemm_f32<T, KN, EPI, EX, AS, true>(A, B, bias, res, aux, a_scale, out_scale, out, M, \
                                            N, K, rows_per_sample, stream, drop)
    switch (epilogue) {
      case 1:
        if constexpr (!KN) {
          if (as) break;
          return out_scale != nullptr ? CSWIN_GEMM_F32_DROP(1, true, false)
                                      : CSWIN_GEMM_F32_DROP(1, false, false);
        }
        break;
      case 2:
        if constexpr (!KN) {
          if (as) break;
          return aux != nullptr ? CSWIN_GEMM_F32_DROP(2, true, false)
                                : CSWIN_GEMM_F32_DROP(2, false, false);
        }
        break;
      case 3:
        return as ? CSWIN_GEMM_F32_DROP(3, false, true) : CSWIN_GEMM_F32_DROP(3, false, false);
    }
#undef CSWIN_GEMM_F32_DROP
    return (int)cudaErrorInvalidValue;
  }
#define CSWIN_GEMM_F32(EPI, EX, AS)                                                         \
  launch_gemm_f32<T, KN, EPI, EX, AS>(A, B, bias, res, aux, a_scale, out_scale, out, M, N, K, \
                                      rows_per_sample, stream)
  switch (epilogue) {
    case 0: return as ? CSWIN_GEMM_F32(0, false, true) : CSWIN_GEMM_F32(0, false, false);
    case 1:
      if constexpr (!KN) {
        if (as) break;
        return out_scale != nullptr ? CSWIN_GEMM_F32(1, true, false)
                                    : CSWIN_GEMM_F32(1, false, false);
      }
      break;
    case 2:
      if constexpr (!KN) {
        if (as) break;
        return aux != nullptr ? CSWIN_GEMM_F32(2, true, false) : CSWIN_GEMM_F32(2, false, false);
      }
      break;
    case 3: return as ? CSWIN_GEMM_F32(3, false, true) : CSWIN_GEMM_F32(3, false, false);
  }
#undef CSWIN_GEMM_F32
  return (int)cudaErrorInvalidValue;
}

// The planner's tiles, by (bm, bn): 64 x 64, and 128 x 32 for N whose
// 32-column tiles waste fewer columns (base-384's C = 96).
using Tile64x64 = Tile<64, 64>;
using Tile128x32 = Tile<128, 32>;

// --- the weight gradient --------------------------------------------------

namespace wgrad_f32 {

constexpr int MS = 32;      // rows of M a ring stage (the split chunks are multiples)
constexpr int STAGES = 3;   // two stages in flight during the products

// The ring of a BN x BK output tile: MS rows a stage of dY and X, unpadded
// (a warp reads one row m at a time, consecutive 16-byte words), and the
// staged rows' scales.
template <int BN, int BK>
struct __align__(128) Smem {
  float D[STAGES][MS][BN];
  float X[STAGES][MS][BK];
  float sc[STAGES][MS];
};

}  // namespace wgrad_f32

// Grid (splits, tiles), clusters of `cluster` CTAs along the splits; CTA
// (split, tile) reduces rows [split·chunk, +chunk) of M into the tile's
// float32 sums (each output one fmaf chain over its rows in order), which
// wgrad_sum::sum_tile adds over the splits. The pass over each landed stage of
// dY: each thread takes quads (4 columns) q = tid % (BN/4) of rows tid /
// (BN/4) + (NT·4/BN)·s, scales and masks them in place and adds them to
// its db partial; after the last stage the NT·4/BN partials of a column
// are added in row-group order.
// Two CTAs an SM (at most 128 registers a thread for the 256-thread tile),
// but one for the 256-thread DROP instance, whose mask would spill there.
template <int BN, int BK, bool DROP>
__global__ void __launch_bounds__(BN * BK / 64, BN * BK / 64 > 128 && DROP ? 1 : 2)
wgrad_f32_kernel(const float* __restrict__ X, const float* __restrict__ dY,
                 const float* __restrict__ dy_scale, float* __restrict__ dw,
                 float* __restrict__ db, float* __restrict__ part_w,
                 float* __restrict__ part_b, int* __restrict__ arrivals, int M, int N, int K,
                 int rows_per_sample, int chunk, int tk, DropArgs drop) {
  using namespace wgrad_f32;
  constexpr int NT = BN * BK / 64;   // threads: 8 x 8 outputs each
  constexpr int TK = BK / 8;         // threads along k
  constexpr int QUADS = BN / 4;      // 16-byte words of a dY row
  constexpr int RG = NT / QUADS;     // row groups of the dY pass
  constexpr int LDC = BK + 4;
  using Ring = Smem<BN, BK>;
  static_assert(NT % QUADS == 0 && MS % RG == 0, "the dY pass covers a stage in whole rows");
  static_assert(sizeof(float) * (BN * LDC + BN + RG * BN) <= sizeof(Ring),
                "the sum tile, db and its partials fit the ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Ring& sm = *reinterpret_cast<Ring*>(smem_raw);

  const int tid = threadIdx.x, tkk = tid % TK, tnn = tid / TK;
  const int tile = blockIdx.y, nt = tile / tk;
  const int n0 = nt * BN, k0 = tile % tk * BK;
  const int m_begin = min(M, blockIdx.x * chunk), m_end = min(M, m_begin + chunk);
  const int steps = (m_end - m_begin + MS - 1) / MS;
  const bool with_bias = db != nullptr && k0 == 0;  // the first K tile's CTAs sum db
  const bool scaled = dy_scale != nullptr;

  const auto load = [&](int step, int slot) {
    const int m0 = m_begin + step * MS;
    constexpr int CD = BN / 4, CX = BK / 4;  // 16-byte chunks a row
    static_assert(MS * (CD + CX) % NT == 0, "whole passes");
#pragma unroll
    for (int it = 0; it < MS * (CD + CX) / NT; ++it) {
      const int i = tid + it * NT;
      if (i < MS * CD) {
        const int r = i / CD, c = i % CD * 4, gm = m0 + r;
        const bool ok = gm < m_end && n0 + c < N;
        cp_async16(&sm.D[slot][r][c], ok ? dY + (size_t)gm * N + n0 + c : dY, ok ? 16 : 0);
      } else {
        const int j = i - MS * CD, r = j / CX, c = j % CX * 4, gm = m0 + r;
        const bool ok = gm < m_end && k0 + c < K;
        cp_async16(&sm.X[slot][r][c], ok ? X + (size_t)gm * K + k0 + c : X, ok ? 16 : 0);
      }
    }
    if (scaled && tid < MS) {
      const bool ok = m0 + tid < m_end;
      wgrad_sum::cp_async4(&sm.sc[slot][tid],
                       ok ? dy_scale + (m0 + tid) / rows_per_sample : dy_scale, ok ? 4 : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float4 bsum = make_float4(0.f, 0.f, 0.f, 0.f);  // db of quad tid % QUADS, this row group
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  // DROP: dY's dropout key (drop.key_a), read once.
  const unsigned long long key = DROP ? *drop.key_a : 0ull;
  const int q = tid % QUADS, rg = tid / QUADS;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();  // step `step` has landed (this thread's copies)
    __syncthreads();              // everyone's, and slot (step - 1) % STAGES is free
    const int nx = step + STAGES - 1;
    if (nx < steps) load(nx, nx % STAGES);
    cp_async_commit();
    const int slot = step % STAGES;
    if (DROP || scaled || with_bias) {
      // dY' in place: each value times its row's scale, then v / kd where
      // kept, else 0 (one Philox block a four columns; N % 8 == 0), and
      // into db; rows past the chunk and columns past N stay zero.
      const int m0 = m_begin + step * MS;
#pragma unroll
      for (int s = 0; s < MS / RG; ++s) {
        const int r = rg + RG * s, gm = m0 + r, gn = n0 + 4 * q;
        if (gm >= m_end || gn >= N) continue;
        float4* p = reinterpret_cast<float4*>(&sm.D[slot][r][4 * q]);
        float4 v = *p;
        if (DROP || scaled) {
          float e[4] = {v.x, v.y, v.z, v.w};
          const float sv = scaled ? sm.sc[slot][r] : 1.f;
          uint32_t bits = 0xFu;
          if constexpr (DROP)
            bits = keep4(key, ((unsigned long long)(drop.row0 + gm) * N + gn) >> 2, drop.thr);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (scaled) e[t] *= sv;
            if constexpr (DROP) e[t] = (bits >> t & 1u) ? e[t] / drop.kd : 0.f;
          }
          v = make_float4(e[0], e[1], e[2], e[3]);
          *p = v;
        }
        if (with_bias) bsum = wgrad_sum::add4(bsum, v);
      }
      if (DROP || scaled) __syncthreads();
    }
    // Row m's rank-one update. The 256-thread tile unrolls two rows, so that
    // it fits 128 registers (two CTAs an SM) without spilling; the others
    // four.
    const auto row = [&](int m) {
      const float4 d0 = *reinterpret_cast<const float4*>(&sm.D[slot][m][4 * tnn]);
      const float4 d1 = *reinterpret_cast<const float4*>(&sm.D[slot][m][BN / 2 + 4 * tnn]);
      const float4 x0 = *reinterpret_cast<const float4*>(&sm.X[slot][m][4 * tkk]);
      const float4 x1 = *reinterpret_cast<const float4*>(&sm.X[slot][m][BK / 2 + 4 * tkk]);
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(d[i], x[j], acc[i][j]);
    };
    if constexpr (NT > 128) {
#pragma unroll 2
      for (int m = 0; m < MS; ++m) row(m);
    } else {
#pragma unroll 4
      for (int m = 0; m < MS; ++m) row(m);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: the float32 tile goes there

  float (*Cs)[LDC] = reinterpret_cast<float (*)[LDC]>(smem_raw);
  float* Bs = &Cs[BN][0];
  float* Bp = Bs + BN;  // RG rows of BN: the db partials by row group
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : BN / 2) + 4 * tnn + (i & 3);
    *reinterpret_cast<float4*>(&Cs[r][4 * tkk]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&Cs[r][BK / 2 + 4 * tkk]) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (with_bias) {
    *reinterpret_cast<float4*>(&Bp[rg * BN + 4 * q]) = bsum;
    __syncthreads();
    if (tid < BN) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < RG; ++g) s += Bp[g * BN + tid];
      Bs[tid] = s;
    }
  }
  wgrad_sum::sum_tile<BN, BK, NT>(smem_raw, dw, db, part_w, part_b, arrivals, N, K, tile, nt, n0,
                              k0, with_bias);
}

// X: (M, K), dY: (M, N) float32; every other argument as cswin_gemm_wgrad's
// (gemm.cu), with chunk a multiple of wgrad_f32::MS.
int wgrad_f32_entry(const void* X, const void* dY, const void* dy_scale, void* dw, void* db,
                    void* part_w, void* part_b, void* arrivals, int M, int N, int K,
                    int rows_per_sample, int chunk, int splits, int cluster, int bn, int bk,
                    const void* key, long long row0, float kd, unsigned thr, void* stream,
                    int* probe) {
  if (cluster < 1 || cluster > wgrad_sum::MAX_CLUSTER || (cluster & (cluster - 1)) ||
      splits % cluster || chunk % wgrad_f32::MS)
    return (int)cudaErrorInvalidValue;
  DropArgs drop;
  drop.key_a = (const unsigned long long*)key;
  drop.row0 = row0;
  drop.kd = kd;
  drop.thr = thr;
  const int tk = (K + bk - 1) / bk, tiles = (N + bn - 1) / bn * tk;
#define CSWIN_WGRAD_F32_AS(BN, BK, DROP)                                                       \
  wgrad_sum::launch_clusters(wgrad_f32_kernel<BN, BK, DROP>, splits, tiles, cluster, BN * BK / 64, \
                         sizeof(wgrad_f32::Smem<BN, BK>), (cudaStream_t)stream, probe,         \
                         (const float*)X, (const float*)dY, (const float*)dy_scale, (float*)dw, \
                         (float*)db, (float*)part_w, (float*)part_b, (int*)arrivals, M, N, K,  \
                         rows_per_sample, chunk, tk, drop)
#define CSWIN_WGRAD_F32(BN, BK) \
  (key != nullptr ? CSWIN_WGRAD_F32_AS(BN, BK, true) : CSWIN_WGRAD_F32_AS(BN, BK, false))
  if (bn == 64 && bk == 64) return (int)CSWIN_WGRAD_F32(64, 64);
  if (bn == 128 && bk == 64) return (int)CSWIN_WGRAD_F32(128, 64);
  if (bn == 64 && bk == 128) return (int)CSWIN_WGRAD_F32(64, 128);
  if (bn == 128 && bk == 128) return (int)CSWIN_WGRAD_F32(128, 128);
#undef CSWIN_WGRAD_F32
#undef CSWIN_WGRAD_F32_AS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A, B, res, aux, out: float32 (M, K), (N, K), (M, N), or with b_kn B as
// (K, N) (the dX product's weight as stored; epilogues 0 and 3, N % 4 == 0);
// every other argument as cswin_gemm's (gemm.cu), and the tile: bm x bn of
// 64 x 64 or 128 x 32 (kernels.gemm_f32_plan; either gives the same bits).
// Requires K % 4 == 0 and 16-byte aligned A and B (checked by the wrapper);
// at most 2^31 - 1 output tiles.
CSWIN_API int cswin_gemm_f32(const void* A, const void* B, const void* bias, const void* res,
                             void* aux, const void* a_scale, const void* out_scale, void* out,
                             int M, int N, int K, int rows_per_sample, int epilogue,
                             const void* key_a, const void* key_out, long long row0, float kd,
                             unsigned thr, int bm, int bn, int b_kn, void* stream) {
  if (b_kn && N % 4) return (int)cudaErrorInvalidValue;
#define CSWIN_GEMM_F32_TILE(T)                                                                  \
  (b_kn ? gemm_f32_entry<T, true>(A, B, bias, res, aux, a_scale, out_scale, out, M, N, K,       \
                                  rows_per_sample, epilogue, key_a, key_out, row0, kd, thr,     \
                                  stream)                                                       \
        : gemm_f32_entry<T, false>(A, B, bias, res, aux, a_scale, out_scale, out, M, N, K,      \
                                   rows_per_sample, epilogue, key_a, key_out, row0, kd, thr,    \
                                   stream))
  if (bm == 64 && bn == 64) return CSWIN_GEMM_F32_TILE(Tile64x64);
  if (bm == 128 && bn == 32) return CSWIN_GEMM_F32_TILE(Tile128x32);
#undef CSWIN_GEMM_F32_TILE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bm x bn float32 GEMM tile, with B as (N, K)
// or with b_kn as (K, N) (the planner's mirror is held to it), or -1 for a
// tile with no instance.
template <typename T>
int gemm_f32_smem(bool kn) {
  return kn ? (int)sizeof(gemm_f32::Smem<T::bm, T::bn, true>)
            : (int)sizeof(gemm_f32::Smem<T::bm, T::bn, false>);
}

CSWIN_API int cswin_gemm_f32_smem(int bm, int bn, int b_kn) {
  if (bm == 64 && bn == 64) return gemm_f32_smem<Tile64x64>(b_kn != 0);
  if (bm == 128 && bn == 32) return gemm_f32_smem<Tile128x32>(b_kn != 0);
  return -1;
}

CSWIN_API int cswin_gemm_wgrad_f32(const void* X, const void* dY, const void* dy_scale,
                                   void* dw, void* db, void* part_w, void* part_b,
                                   void* arrivals, int M, int N, int K, int rows_per_sample,
                                   int chunk, int splits, int cluster, int bn, int bk,
                                   const void* key, long long row0, float kd, unsigned thr,
                                   void* stream) {
  return wgrad_f32_entry(X, dY, dy_scale, dw, db, part_w, part_b, arrivals, M, N, K,
                         rows_per_sample, chunk, splits, cluster, bn, bk, key, row0, kd, thr,
                         stream, nullptr);
}

// How many clusters of `cluster` CTAs of the bn x bk float32 weight-gradient
// kernel the card runs at once (cudaOccupancyMaxActiveClusters), or -1.
CSWIN_API int cswin_gemm_wgrad_f32_max_clusters(int bn, int bk, int cluster) {
  int n = -1;
  const int err = wgrad_f32_entry(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, 32, bn, bk, 1, 32, cluster, cluster, bn, bk, nullptr,
                                  0, 1.f, 0u, nullptr, &n);
  return err == (int)cudaSuccess ? n : -1;
}
