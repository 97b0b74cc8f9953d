// Tiled bf16 GEMMs of the CSWin block, forward and backward, float32
// accumulation. Their float32 instances (TPU.COMPUTE_DTYPE float32) are
// gemm_f32.cu's; the weight gradients' cross-split sums (sum_tile) are
// wgrad_sum.cuh's, shared by both.
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
// Dropout (philox.cuh; training at MODEL.DROP_RATE > 0), a separate
// instance of epilogues 1-3: a kept value v becomes round(round(v) / kd),
// a dropped one 0, where
//   1  the branch, before the drop-path multiplier: out = res +
//      bf16(D(bf16(acc + bias)) · dp)
//   2  the GELU output (the pre-activation written to aux is not masked)
//   3  dY' as it lands in shared memory, after its drop-path scale (the fc2
//      site's mask), and the product before GELU' (the fc1 site's mask):
//      out = D(acc) · (Φ(h) + h·φ(h))
//
// cswin_gemm_wgrad: weight gradient dW = dY'ᵀ · X over M rows and bias
// gradient db = Σ dY', both float32; dY' is dY with the same optional
// per-sample row scale, rounded to bf16 before the products, and with
// dropout masked as epilogue 3 masks it (in the ring, before the
// fragments are read). The partial
// sums over chunks of M are added inside the kernel, in a fixed order.
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
//   from L2, and M may exceed 65535 tiles.
// The weight gradient contracts over M, along which both operands lie
//   row-major: output tiles of 64 or 128 along N and K (128 where it
//   divides, so fewer tiles re-read the narrow operand), warps of 32x32 on
//   mma.sync with both operands through ldmatrix.trans from m-major tiles
//   (no transpose pass), fed by a four-stage ring of 16-byte cp.async
//   copies 64 rows deep; the drop-path scales ride the ring too and
//   multiply the A fragments in registers (each half by its own row's
//   scale, so any rows_per_sample works), and db is one more product,
//   dY'ᵀ · ones, on the same fragments. The grid is one wave, sized by the
//   occupancy API: each output tile's M is split over as many CTAs as fit
//   beside the other tiles', each streaming one long chunk, so the ring,
//   not oversubscription, hides the latency. The splits' float32 tiles are
//   summed in the kernel in a fixed order (no atomics on the sums, no
//   second launch): across a cluster of up to 8 CTAs through distributed
//   shared memory, then, where a tile has several clusters, by the last
//   cluster to arrive (a counter after a fence), from the clusters'
//   partials in L2, which the planner keeps under an eighth of the
//   operands' bytes.

#include "gemm_tile.cuh"
#include "wgrad_sum.cuh"

namespace {

using gemm_tile::THREADS;

// One output tile per CTA: blockIdx.x walks the tiles, N inner (tn tiles
// an M tile).
template <int EPI, bool A_SCALED, bool EXTRA, bool DROP>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const float* __restrict__ bias, const bf16* __restrict__ res,
            bf16* __restrict__ aux, const float* __restrict__ a_scale,
            const float* __restrict__ out_scale, bf16* __restrict__ out, int M,
            int N, int K, int rows_per_sample, int tn, DropArgs drop) {
  __shared__ gemm_tile::Smem sm;
  const int t = blockIdx.x;
  gemm_tile::tile<EPI, A_SCALED, EXTRA, DROP>(A, B, bias, res, aux, a_scale, out_scale, out,
                                              M, N, K, rows_per_sample,
                                              t / tn * gemm_tile::BM, t % tn * gemm_tile::BN,
                                              sm, drop);
}

// --- the weight gradient --------------------------------------------------

namespace wgrad {

constexpr int MS = 64;           // rows of M a ring stage (the split chunks are multiples)
constexpr int STAGES = 4;        // three stages in flight during the products
constexpr uint32_t ONES = 0x3F803F80u;  // two bf16 1.0: the B operand of the bias sum

// The ring of a BN x BK output tile (BN rows of dW over N, BK columns over
// K); rows padded by 8 bf16 so that ldmatrix reads them without conflicts.
template <int BN, int BK>
struct __align__(128) Smem {
  bf16 D[STAGES][MS][BN + 8];  // dY, rows m, columns n
  bf16 X[STAGES][MS][BK + 8];  // X, rows m, columns k
  float sc[STAGES][MS];        // the drop-path multiplier of each staged row
};

// Both halves of a bf16x2 register, each times its own scale, rounded back.
__device__ __forceinline__ uint32_t scale2(uint32_t v, float s0, float s1) {
  const float2 f = unpack_bf16(v);
  return pack_bf16(f.x * s0, f.y * s1);
}

}  // namespace wgrad

// Grid (splits, tiles), clusters of `cluster` CTAs along the splits; warps
// of 32x32 over the BN x BK tile. CTA (split, tile) reduces rows
// [split·chunk, +chunk) of M into the tile's float32 sums, which sum_tile
// adds over the splits.
template <int BN, int BK, bool DROP>
__global__ void __launch_bounds__(BN * BK / 32, 1)
wgrad_kernel(const bf16* __restrict__ X, const bf16* __restrict__ dY,
             const float* __restrict__ dy_scale, float* __restrict__ dw,
             float* __restrict__ db, float* __restrict__ part_w,
             float* __restrict__ part_b, int* __restrict__ arrivals, int M, int N, int K,
             int rows_per_sample, int chunk, int tk, DropArgs drop) {
  using namespace wgrad;
  constexpr int NT = BN * BK / 32;    // threads: one warp per 32x32 of the tile
  constexpr int WK = BK / 32;         // warps along k
  constexpr int LDC = BK + 4;         // row stride of the float32 tile the cluster sums
  using Ring = Smem<BN, BK>;
  static_assert(sizeof(float) * (BN * LDC + BN) <= sizeof(Ring), "the sum tile fits the ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Ring& sm = *reinterpret_cast<Ring*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp / WK, wk = warp % WK;
  const int g = lane >> 2, q4 = lane & 3;
  const int tile = blockIdx.y, nt = tile / tk;
  const int n0 = nt * BN, k0 = tile % tk * BK;
  const int m_begin = min(M, blockIdx.x * chunk), m_end = min(M, m_begin + chunk);
  const int steps = (m_end - m_begin + MS - 1) / MS;
  const bool with_bias = db != nullptr && k0 == 0;  // the first K tile's CTAs sum db
  const bool scaled = dy_scale != nullptr;

  // Copies of step `step` into ring slot `slot`: 64 rows of dY and of X in
  // 16-byte chunks; rows past the chunk, columns past N or K are
  // zero-filled, and so are the scales of rows past the chunk.
  const auto load = [&](int step, int slot) {
    const int m0 = m_begin + step * MS;
    constexpr int CD = BN / 8, CX = BK / 8;  // chunks a row
    static_assert(MS * (CD + CX) % NT == 0, "whole passes");
#pragma unroll
    for (int it = 0; it < MS * (CD + CX) / NT; ++it) {
      const int i = tid + it * NT;
      if (i < MS * CD) {
        const int r = i / CD, c = i % CD * 8, gm = m0 + r;
        const bool ok = gm < m_end && n0 + c < N;
        cp_async16(&sm.D[slot][r][c], ok ? dY + (size_t)gm * N + n0 + c : dY, ok ? 16 : 0);
      } else {
        const int j = i - MS * CD, r = j / CX, c = j % CX * 8, gm = m0 + r;
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

  float acc[2][4][4], bacc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    bacc[i][0] = bacc[i][1] = bacc[i][2] = bacc[i][3] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  // DROP: dY's dropout key (drop.key_a), read once.
  const unsigned long long key = DROP ? *drop.key_a : 0ull;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();  // step `step` has landed (this thread's copies)
    __syncthreads();              // everyone's, and slot (step - 1) % STAGES is free
    const int nx = step + STAGES - 1;
    if (nx < steps) load(nx, nx % STAGES);
    cp_async_commit();
    const int slot = step % STAGES;
    if constexpr (DROP) {
      // dY' in place: each value times its row's scale, rounded, then
      // round(v / kd) where kept, else 0 (one Philox block a four columns;
      // N % 8 == 0). The fragments below are then not scaled again.
      const int m0 = m_begin + step * MS;
      constexpr int QUADS = BN / 4;
      for (int i = tid; i < MS * QUADS; i += NT) {
        const int r = i / QUADS, c = i % QUADS * 4, gm = m0 + r, gn = n0 + c;
        if (gm >= m_end || gn >= N) continue;
        const uint32_t bits =
            keep4(key, ((unsigned long long)(drop.row0 + gm) * N + gn) >> 2, drop.thr);
        uint2* p = reinterpret_cast<uint2*>(&sm.D[slot][r][c]);
        const float2 lo = unpack_bf16(p->x), hi = unpack_bf16(p->y);
        float v[4] = {lo.x, lo.y, hi.x, hi.y};
        const float s = scaled ? sm.sc[slot][r] : 1.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (scaled) v[e] = round_bf16(v[e] * s);
          v[e] = (bits >> e & 1u) ? v[e] / drop.kd : 0.f;
        }
        *p = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < MS; kk += 16) {
      // A = dY'ᵀ (rows n, columns m) from the m-major tile: ldmatrix.trans.
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4<true>(a[i], &sm.D[slot][kk + (lane & 7) + (lane >> 4) * 8]
                                 [wn * 32 + i * 16 + ((lane >> 3) & 1) * 8]);
      if (scaled && !DROP) {
        // a[.][0..1] hold rows m = kk + 2q, 2q + 1; a[.][2..3] rows 2q + 8, 2q + 9.
        const float2 s01 = *reinterpret_cast<const float2*>(&sm.sc[slot][kk + 2 * q4]);
        const float2 s89 = *reinterpret_cast<const float2*>(&sm.sc[slot][kk + 8 + 2 * q4]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = scale2(a[i][0], s01.x, s01.y);
          a[i][1] = scale2(a[i][1], s01.x, s01.y);
          a[i][2] = scale2(a[i][2], s89.x, s89.y);
          a[i][3] = scale2(a[i][3], s89.x, s89.y);
        }
      }
      // B = X (rows m, columns k), m-major as well: ldmatrix.trans.
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldsm_x4<true>(r, &sm.X[slot][kk + ((lane >> 3) & 1) * 8 + (lane & 7)]
                               [wk * 32 + jp * 16 + (lane >> 4) * 8]);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      // db = dY'ᵀ · ones: every column of bacc holds its row's sum.
      if (with_bias && wk == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(bacc[i], a[i], ONES, ONES);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: the float32 tile goes there

  float (*Cs)[LDC] = reinterpret_cast<float (*)[LDC]>(smem_raw);
  float* Bs = &Cs[BN][0];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wn * 32 + i * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(&Cs[r][wk * 32 + j * 8 + 2 * q4]) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      if (with_bias && wk == 0 && q4 == 0) Bs[r] = bacc[i][2 * h];
    }
  wgrad_sum::sum_tile<BN, BK, NT>(smem_raw, dw, db, part_w, part_b, arrivals, N, K, tile, nt,
                                  n0, k0, with_bias);
}

// The cluster launch of one tile shape of the kernel; `probe` asks only how
// many clusters of that size fit on the card at once.
template <int BN, int BK, bool DROP>
cudaError_t launch_wgrad(const bf16* X, const bf16* dY, const float* dy_scale, float* dw,
                         float* db, float* part_w, float* part_b, int* arrivals, int M, int N,
                         int K, int rows_per_sample, int chunk, int splits, int cluster,
                         const DropArgs& drop, cudaStream_t stream, int* probe) {
  const int tk = (K + BK - 1) / BK, tiles = (N + BN - 1) / BN * tk;
  return wgrad_sum::launch_clusters(wgrad_kernel<BN, BK, DROP>, splits, tiles, cluster,
                                    BN * BK / 32, sizeof(wgrad::Smem<BN, BK>), stream, probe, X,
                                    dY, dy_scale, dw, db, part_w, part_b, arrivals, M, N, K,
                                    rows_per_sample, chunk, tk, drop);
}

template <int EPI, bool A_SCALED, bool EXTRA, bool DROP = false>
int launch_gemm(const void* A, const void* B, const void* bias, const void* res,
                void* aux, const void* a_scale, const void* out_scale, void* out,
                int M, int N, int K, int rows_per_sample, void* stream,
                const DropArgs& drop = DropArgs()) {
  const int tn = (N + gemm_tile::BN - 1) / gemm_tile::BN;
  const long long tiles = (long long)((M + gemm_tile::BM - 1) / gemm_tile::BM) * tn;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gemm_kernel<EPI, A_SCALED, EXTRA, DROP><<<(unsigned)tiles, THREADS, 0,
                                             (cudaStream_t)stream>>>(
      (const bf16*)A, (const bf16*)B, (const float*)bias, (const bf16*)res,
      (bf16*)aux, (const float*)a_scale, (const float*)out_scale, (bf16*)out, M,
      N, K, rows_per_sample, tn, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// A, B, res, aux, out: bf16; bias, a_scale, out_scale: float32 or null.
// res is read by epilogue 1, aux written by epilogue 2 (if not null) and read
// by epilogue 3; a_scale (epilogues 0 and 3) and out_scale (epilogue 1) are
// per-sample (row / rows_per_sample). key_out (epilogues 1-3) and key_a
// (epilogue 3) point at a site's 64-bit dropout key on the device or are
// null: with either, row0, kd and thr are the dropout's (philox.cuh) and
// N % 8 == 0. Other combinations return cudaErrorInvalidValue. Requires
// K % 8 == 0 and 16-byte aligned A and B (checked by the wrapper); at most
// 2^31 - 1 output tiles of 64 x 64.
CSWIN_API int cswin_gemm(const void* A, const void* B, const void* bias,
                         const void* res, void* aux, const void* a_scale,
                         const void* out_scale, void* out, int M, int N, int K,
                         int rows_per_sample, int epilogue, const void* key_a,
                         const void* key_out, long long row0, float kd, unsigned thr,
                         void* stream) {
  if (key_a != nullptr || key_out != nullptr) {
    if (N % 8 || epilogue < 1 || epilogue > 3 || (key_a != nullptr && epilogue != 3))
      return (int)cudaErrorInvalidValue;
    DropArgs drop;
    drop.key_a = (const unsigned long long*)key_a;
    drop.key_out = (const unsigned long long*)key_out;
    drop.row0 = row0;
    drop.kd = kd;
    drop.thr = thr;
#define CSWIN_GEMM_DROP(EPI, AS, EX)                                                    \
  launch_gemm<EPI, AS, EX, true>(A, B, bias, res, aux, a_scale, out_scale, out, M, N, K, \
                                 rows_per_sample, stream, drop)
    const bool as = a_scale != nullptr;
    switch (epilogue) {
      case 1:
        if (as) break;
        return out_scale != nullptr ? CSWIN_GEMM_DROP(1, false, true)
                                    : CSWIN_GEMM_DROP(1, false, false);
      case 2:
        if (as) break;
        return aux != nullptr ? CSWIN_GEMM_DROP(2, false, true)
                              : CSWIN_GEMM_DROP(2, false, false);
      case 3:
        return as ? CSWIN_GEMM_DROP(3, true, false) : CSWIN_GEMM_DROP(3, false, false);
    }
#undef CSWIN_GEMM_DROP
    return (int)cudaErrorInvalidValue;
  }
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
// key: dY's 64-bit dropout key on the device or null (row0, kd, thr as in
// cswin_gemm);
// dw: (N, K) float32; db: (N,) float32 or null. Tiles of bn x bk over
// (N, K), each 64 or 128; grid (splits, tiles) in clusters of `cluster` CTAs
// (1, 2, 4 or 8, dividing splits and bn); split s reduces rows [s·chunk,
// min(M, (s+1)·chunk)). With more than one cluster a tile (splits / cluster
// > 1) the clusters' sums go through part_w (tiles, clusters, bn, bk) and
// part_b (N tiles, clusters, bn), float32, and `arrivals` (tiles x 8 ints,
// zero, left zero); else those are unread. Requires N % 8 == 0, K % 8 ==
// 0, chunk % 64 == 0 and 16-byte aligned X and dY (checked by the wrapper).
static int wgrad_entry(const void* X, const void* dY, const void* dy_scale, void* dw,
                       void* db, void* part_w, void* part_b, void* arrivals, int M, int N,
                       int K, int rows_per_sample, int chunk, int splits, int cluster, int bn,
                       int bk, const void* key, long long row0, float kd, unsigned thr,
                       void* stream, int* probe) {
  if (cluster < 1 || cluster > wgrad_sum::MAX_CLUSTER || (cluster & (cluster - 1)) ||
      splits % cluster || chunk % wgrad::MS)
    return (int)cudaErrorInvalidValue;
  DropArgs drop;
  drop.key_a = (const unsigned long long*)key;
  drop.row0 = row0;
  drop.kd = kd;
  drop.thr = thr;
#define CSWIN_WGRAD_AS(BN, BK, DROP)                                                          \
  launch_wgrad<BN, BK, DROP>((const bf16*)X, (const bf16*)dY, (const float*)dy_scale,         \
                             (float*)dw, (float*)db, (float*)part_w, (float*)part_b,          \
                             (int*)arrivals, M, N, K, rows_per_sample, chunk, splits, cluster, \
                             drop, (cudaStream_t)stream, probe)
#define CSWIN_WGRAD(BN, BK) \
  (key != nullptr ? CSWIN_WGRAD_AS(BN, BK, true) : CSWIN_WGRAD_AS(BN, BK, false))
  if (bn == 64 && bk == 64) return (int)CSWIN_WGRAD(64, 64);
  if (bn == 128 && bk == 64) return (int)CSWIN_WGRAD(128, 64);
  if (bn == 64 && bk == 128) return (int)CSWIN_WGRAD(64, 128);
  if (bn == 128 && bk == 128) return (int)CSWIN_WGRAD(128, 128);
#undef CSWIN_WGRAD
#undef CSWIN_WGRAD_AS
  return (int)cudaErrorInvalidValue;
}

CSWIN_API int cswin_gemm_wgrad(const void* X, const void* dY, const void* dy_scale, void* dw,
                               void* db, void* part_w, void* part_b, void* arrivals, int M,
                               int N, int K, int rows_per_sample, int chunk, int splits,
                               int cluster, int bn, int bk, const void* key, long long row0,
                               float kd, unsigned thr, void* stream) {
  return wgrad_entry(X, dY, dy_scale, dw, db, part_w, part_b, arrivals, M, N, K,
                     rows_per_sample, chunk, splits, cluster, bn, bk, key, row0, kd, thr, stream,
                     nullptr);
}

// How many clusters of `cluster` CTAs of the bn x bk weight-gradient kernel
// the card runs at once (cudaOccupancyMaxActiveClusters), or -1: what sizes
// the wrapper's one wave.
CSWIN_API int cswin_gemm_wgrad_max_clusters(int bn, int bk, int cluster) {
  int n = -1;
  const int err = wgrad_entry(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, 64, bn, bk, 1, 64, cluster, cluster, bn, bk, nullptr, 0,
                              1.f, 0u, nullptr, &n);
  return err == (int)cudaSuccess ? n : -1;
}
