// Backward of one CSWin stripe branch (window attention + LePE).
//
// Reads q, k and v straight from the forward's (B, H, W, 3C) qkv output and
// the branch's output gradient dO from a (B, H, W, C) tensor, both at the
// branch's channel offset `ch_off`, as the forward does. Per (window, head)
// it recomputes the scores and the float32 softmax (nothing is saved by the
// forward) and applies the softmax-attention vjp with the rounding points
// of the JAX backward:
//   S  = bf16(q·scale)·Kᵀ,  P = softmax(S) (f32),  P_b = bf16(P)
//   dV = P_bᵀ·dO            dP = dO·Vᵀ
//   dS = P∘(dP − rowsum(dP∘P)),  dS_b = bf16(dS)
//   dQ = dS_b·K·scale       dK = dS_bᵀ·bf16(q·scale)
// and the LePE backward: dV += the transposed 3x3 depthwise conv of dO,
// zero padded at the window's borders, added in float32 before dV's one
// rounding; per-window float32 partials of the LePE weight gradient
// dW[tap][c] = Σ_t dO[t][c]·V[t + tap][c] and of the bias gradient
// Σ_t dO[t][c] (the wrapper sums them, one reduction). dQ, dK
// and dV land in bf16 at the branch's channel offset of the q, k and v thirds of a
// (B, H, W, 3C) dqkv buffer, so both branches of a block fill one buffer
// that feeds the qkv weight-gradient and dX products directly.
//
// Replaces: the attention + LePE part of the TPU block backward,
//   cswin_unet_tpu/ops/pallas/cswin_block.py::_block_bwd_kernel_xt, i.e.
//   _attn_windows_bwd (:617-661) and _lepe_windows_bwd (:753-800). The port
//   has one NHWC layout, so there is no transposed (xt) copy of the vertical
//   branch and no column un-split of dW_qkv afterwards.
// Bound on the H100: five L x L x d products a (window, head) on 14·d
//   bytes a token. base-384 trains at L = 96, 96, 288 and 144 (d = 24),
//   tiny-224 at 56, 56, 98 and 49 (d = 32): bytes bound the card's time
//   (2.17 ms a base-384 bs-24 step), so latency, occupancy and the launch
//   shape set the kernel's.
// Route by L (the wrapper's stripe_attention_bwd_plan mirrors it): a window
//   of up to one key block (L <= KB = 64) takes one CTA a (window, head);
//   a longer one a row kernel and then a key kernel on the stream, each
//   many CTAs a (window, head) with shared memory that grows with L·d only.
//   All three are stripe_attention_bwd_kernel instances (<D> the whole
//   window, <D, Part> the split's), the name a trace reads as the attention
//   family. Every sum has a fixed order, no atomics: two calls give the
//   same bits.
// The whole window (tensor cores, after the forward tile attention_tile.cuh;
//   the roundings of the function, not of its sums):
//   * up to one key block of L <= KB = 64 tokens, the window's keys all in
//     one pass: no statistics pass, nothing accumulated across blocks.
//   * staging: q, k, v and dO of the (window, head) land in shared memory
//     as bf16 through 16-byte cp.async copies, rows padded for ldmatrix, L
//     padded to a multiple of 16 with zero rows and D = 24 to a depth of 32
//     with zero columns; q is then scaled and rounded to bf16 in place (the
//     q·scale that both S and dK use).
//   * each warp owns 16-query slabs. S = Q·Kᵀ and dP = dO·Vᵀ run on
//     mma.sync m16n8k16 (bf16 in, float32 out) over the window's keys,
//     padded keys masked to -inf; the softmax, the row sum of dP∘P and dS
//     run on the accumulator fragments (a row lives in one quad of lanes:
//     two shuffles a reduction); P = exp(s - max) · (1 / sum), one division
//     a row (no rounding point of the function lies there). dQ = dS_b·K
//     takes dS_b repacked from C to A fragments and K through
//     ldmatrix.trans, in registers.
//   * dK and dV contract over queries, which span warps: P_b and dS_b go
//     to shared memory as bf16 tiles (LP x 64, 18 KB at L = 56; no L x L
//     float32 tile), and after one barrier each warp owns
//     16-key slabs, dK = dS_bᵀ·Q and dV = P_bᵀ·dO with both operands through
//     ldmatrix.trans; the LePE transpose conv is added in the accumulator
//     layout before dV's rounding. dQ, dK and dV leave through a per-warp
//     staging tile in 16-byte row chunks (whole sectors; stores straight
//     from the fragments write eight rows' half sectors).
//   * the LePE weight and bias partials come last: a lane per (channel pair,
//     token group of 8) with all ten sums in flight, the groups added by
//     shuffles.
// The split (L > KB), after the float32 instance's two kernels:
//   * rows (ROW_PART, row_part): a CTA takes about ROW_PART_TARGET query rows
//     with k and v of the window staged once; a warp takes RG = 8 rows at a
//     time, their q·scale and dO as B fragments from device memory, and
//     computes Sᵀ = K·(q·scale)ᵀ with keys as the mma's 16 rows, so that the
//     scores of 8 rows over up to SPLIT_TILES 16-key tiles fit in registers:
//     S once, the max, sum and P from it, rowsum(dP∘P) and then dS from dPᵀ
//     = V·dOᵀ a tile at a time, dQᵀ = Kᵀ·dS_bᵀ with dS_b moved to B
//     fragments by movmatrix. The rows' max, 1 / sum and rowsum(dP∘P) go to
//     a float32 buffer of the wrapper.
//   * keys (KEY_PART, key_part): a CTA takes up to KEY_PART_TILES tiles of 16
//     keys, a warp each, q·scale, dO and the statistics of the window staged
//     once, k and v of its keys as A fragments in registers; it walks the
//     rows in 16-row steps, recomputes Sᵀ and dPᵀ, forms P and dS from the
//     statistics, P_b and dS_b straight into A fragments, and adds dV =
//     P_bᵀ·dO and dK = dS_bᵀ·(q·scale) in registers; dV gets the LePE
//     transpose conv; the LePE partials of its keys take a row (window, key
//     CTA) of the wrapper's buffer.
//   * at L = 288, d = 24 (base-384's stage 3): rows 48,640 B, four CTAs an
//     SM (127 registers); keys 58,080 B, three CTAs of six warps (96
//     registers); 3 + 3 CTAs a (window, head), where one CTA holding the
//     whole window would take 217 KB, one CTA an SM, and compute S four
//     times in passes over its key blocks. S is computed once in each
//     kernel, dP twice in the row kernel and once in the key kernel.
//
// The float32 instance (cswin_stripe_attention_bwd_f32, TPU.COMPUTE_DTYPE
// float32) computes the same function with nothing rounded: S = q·scale·Kᵀ,
// P = softmax(S), dV = Pᵀ·dO + the LePE transpose conv, dS = P∘(dP −
// rowsum(dP∘P)), dQ = dS·K·scale, dK = dSᵀ·(q·scale), with float32 LePE
// taps. Its products are FFMA (no tensor-core format keeps float32's).
// Bound: the FFMA work (five L x L x d products a (window, head)), so
// operations bound the card's time. float32 P and dS tiles over all queries
// do not fit beside q, k, v and dO, and one CTA a (window, head) would hold
// one CTA an SM at L = 288, so the work is split in two kernels on one
// stream, each many CTAs a (window, head), each output written by one CTA,
// every sum in a fixed order, no atomics:
//   * rows (stripe_attention_bwd_f32_rows_kernel): a CTA takes about
//     ROW_TARGET query rows (rows_per_cta) with k and v of the whole window
//     staged once (row stride D + 4); each warp takes ROWS_B rows at a
//     time, independently, their q and dO rows arriving by cp.async in the
//     warp's double buffer. S and dP come from attention_tile.cuh's score
//     blocks (a lane up to three keys, one fmaf chain over d a score) into
//     the warp's rows; the softmax's max and sum and rowsum(dP∘P) are warp
//     reductions, dS is formed in place, and dQ = dS·K as the forward's P·V
//     (key groups of lanes, a reduce-scatter in a fixed tree). The rows'
//     max, 1 / sum and rowsum(dP∘P) go to a float32 buffer of the wrapper.
//   * keys (stripe_attention_bwd_f32_keys_kernel): a CTA takes up to
//     KEY_BLOCKS blocks of KEYS keys (key_blocks_per_cta), a warp each, with
//     q·scale, dO and the rows' statistics of the whole window staged once
//     by cp.async; lane l of a warp takes key l of its block, its k and v in
//     registers, and walks every row i of the window, two at a time:
//     recomputes S_ij and dP_ij (two fmaf chains each, over even and odd d,
//     added; no branch on the key), forms P_ij from the rows' statistics
//     and adds dS_ij·q_i and P_ij·dO_i into the key's dK and dV in
//     registers, from one broadcast read of q_i and dO_i. dV gets the LePE
//     transpose conv and both leave in 16-byte chunks, with no reduction
//     across warps; the LePE weight and bias partials of the block's tokens
//     (its V against the staged dO; lane (channel pair, token parity)) go to
//     a (windows · key blocks, cb, 10) buffer that the wrapper sums.
//   A CTA stages a window's k and v, or q and dO, once for about 96 rows
//   or 96 keys, and a warp takes whole rows or keys: what a CTA pays before
//   its first product and after its last (staging, cross-warp sums) is a
//   fifth to two thirds of the time at 32 rows or keys a CTA of 4 warps on
//   an H100. S and dP are computed twice (7·d FMAs a pair against 5·d), for
//   shared memory that grows with L·d only: ~105 KB (rows, two CTAs an SM)
//   and ~68 KB (keys, three) at L = 288, d = 24
//   (kernels.stripe_attention_bwd_f32_plan mirrors both).

#include "attention_tile.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int KT = 8;           // n8 key tiles of a key block
constexpr int KB = KT * 8;      // keys of a key block
constexpr int LDP = KB + 8;     // row stride of the P_b / dS_b tiles, bf16

// Row stride of the staged q, k, v, dO in bf16 elements: the head dim padded
// to the products' depth (a multiple of 16) plus 8, so that the eight
// 16-byte rows of an ldmatrix fall in distinct banks.
template <int D>
__host__ __device__ constexpr int row_stride() {
  return (D + 15) / 16 * 16 + 8;
}

// Shared memory of the whole-window kernel at a window of L tokens, 0 past
// one key block (the kernel takes no such window);
// kernels.stripe_attention_bwd_smem mirrors it: q, k, v, dO; P_b and dS_b;
// each warp's two 16-row output tiles; the LePE taps.
template <int D>
__host__ __device__ constexpr size_t smem_bytes(int L) {
  const int LP = (L + 15) / 16 * 16;
  return LP > KB ? 0
                 : (size_t)4 * LP * row_stride<D>() * sizeof(bf16) +
                       (size_t)2 * LP * LDP * sizeof(bf16) +
                       (size_t)WARPS * 2 * 16 * row_stride<D>() * sizeof(bf16) +
                       (size_t)9 * D * sizeof(float);
}

// The split route: windows longer than one key block (L > KB) go to a row
// kernel and a key kernel, many CTAs a (window, head) each.
constexpr int RG = 8;            // query rows of a row-kernel warp's group: the n of Sᵀ = K·Qᵀ
constexpr int ROW_PART_TARGET = 96;  // query rows a row-kernel CTA takes, about
constexpr int KEY_TILE = 16;     // keys of a key-kernel warp: the m of Sᵀ
constexpr int KEY_PART_TILES = 6;    // key tiles a key-kernel CTA takes, at most (a warp each)
constexpr int SPLIT_TILES = 19;  // key tiles of a row group's scores in registers: L <= 304

// The split route's two kernels.
enum BwdPart : int { ROW_PART = 1, KEY_PART = 2 };

struct BwdArgs {
  const bf16* qkv;
  const bf16* dout;
  const bf16* lepe_w;
  bf16* dqkv;
  float* dl_part;
  float* stats;  // the split route's row statistics: (windows, heads, 3, LP)
  int H, W, C, ch_off, cb, h_sp, w_sp;
  float scale;
  int part;      // rows of a row-kernel CTA, or key tiles of a key-kernel CTA
};

// Query rows of a row-kernel CTA at a window of L tokens: the window in
// ceil(L / ROW_PART_TARGET) near-equal parts, each whole row groups of every
// warp.
__host__ __device__ constexpr int split_rows_per_cta(int L) {
  return ((L + (L + ROW_PART_TARGET - 1) / ROW_PART_TARGET - 1) /
              ((L + ROW_PART_TARGET - 1) / ROW_PART_TARGET) +
          RG * WARPS - 1) / (RG * WARPS) * (RG * WARPS);
}

// Key tiles of a key-kernel CTA: the window's tiles in ceil(tiles /
// KEY_PART_TILES) near-equal parts.
__host__ __device__ constexpr int split_key_tiles_per_cta(int L) {
  return ((L + KEY_TILE - 1) / KEY_TILE +
          ((L + KEY_TILE - 1) / KEY_TILE + KEY_PART_TILES - 1) / KEY_PART_TILES - 1) /
         (((L + KEY_TILE - 1) / KEY_TILE + KEY_PART_TILES - 1) / KEY_PART_TILES);
}

// Shared memory of the row kernel: k and v of the window, and per warp its
// row group's dQ on the way out.
template <int D>
__host__ __device__ constexpr size_t smem_rows_split(int L) {
  return (size_t)2 * ((L + 15) / 16 * 16) * row_stride<D>() * sizeof(bf16) +
         (size_t)WARPS * RG * row_stride<D>() * sizeof(bf16);
}

// Shared memory of the key kernel: q·scale and dO of the window, the rows'
// statistics, the LePE taps, and per warp its key tile's dK or dV on the
// way out.
template <int D>
__host__ __device__ constexpr size_t smem_keys_split(int L) {
  return (size_t)2 * ((L + 15) / 16 * 16) * row_stride<D>() * sizeof(bf16) +
         (size_t)3 * ((L + 15) / 16 * 16) * sizeof(float) + (size_t)9 * D * sizeof(float) +
         (size_t)split_key_tiles_per_cta(L) * KEY_TILE * row_stride<D>() * sizeof(bf16);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// An 8x8 b16 matrix held a row a quad of lanes (lane l: row l / 4, columns
// 2(l % 4) and 2(l % 4) + 1), transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Sum and max over the eight lanes of a quad position (lanes q4, q4 + 4, ...).
__device__ __forceinline__ float column_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The rows [L, LP) of a staged (LP, DP) tile zeroed up to the products'
// depth, and the depth's padding [D, DZ) of the rows below L.
template <int D>
__device__ __forceinline__ void zero_padding(bf16* T, int L, int LP) {
  constexpr int DP = row_stride<D>(), DZ = (D + 15) / 16 * 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < (LP - L) * (DZ / 8); i += blockDim.x)
    *reinterpret_cast<uint4*>(T + (L + i / (DZ / 8)) * DP + i % (DZ / 8) * 8) = zero;
  if constexpr (DZ > D)
    for (int t = threadIdx.x; t < L; t += blockDim.x)
      *reinterpret_cast<uint4*>(T + t * DP + D) = zero;
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
stripe_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                            const bf16* __restrict__ lepe_w, bf16* __restrict__ dqkv,
                            float* __restrict__ dl_part, int H, int W, int C, int ch_off,
                            int cb, int h_sp, int w_sp, float scale) {
  static_assert(D % 8 == 0 && D <= 32, "head dims 16, 24, 32");
  constexpr int DP = row_stride<D>();
  constexpr int DK = (D + 15) / 16;  // k16 steps over the head dim
  constexpr int DZ = DK * 16;        // the depth they read, zero past D
  constexpr int DN = D / 8;          // n8 tiles over the head dim
  constexpr int CH = D / 8;          // 16-byte chunks of a token's head slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = h_sp * w_sp, LP = (L + 15) & ~15;
  const int nt = LP / 8;    // n8 key tiles of the window, at most KT
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + LP * DP;
  bf16* Vs = Ks + LP * DP;
  bf16* Os = Vs + LP * DP;  // dO
  bf16* Pb = Os + LP * DP;  // P_b, LP x KB
  bf16* Sb = Pb + LP * LDP; // dS_b
  bf16* Ow = Sb + LP * LDP; // per warp: two 16-row output tiles on their way out
  float* Tw = reinterpret_cast<float*>(Ow + WARPS * 2 * 16 * DP);  // LePE taps, 9 x D

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int win = blockIdx.x;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * h_sp, col0 = win % n_ww * w_sp;
  const int head = blockIdx.y;
  const int hc = head * D;     // branch-local channel of this head
  const int c0 = ch_off + hc;  // channel in the C-wide layout
  const size_t C3 = 3 * (size_t)C;
  const auto pixel = [&](int t) {  // row of token t in the (B·H·W) layout
    return ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
  };

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH * 8;
    const size_t m = pixel(t);
    const bf16* src = qkv + m * C3 + c0 + c;
    cp_async16(Qs + t * DP + c, src);
    cp_async16(Ks + t * DP + c, src + C);
    cp_async16(Vs + t * DP + c, src + 2 * C);
    cp_async16(Os + t * DP + c, dout + m * C + c0 + c);
  }
  cp_async_commit();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < (LP - L) * (DZ / 8); i += blockDim.x) {
    const int off = (L + i / (DZ / 8)) * DP + i % (DZ / 8) * 8;
    *reinterpret_cast<uint4*>(Qs + off) = zero;
    *reinterpret_cast<uint4*>(Ks + off) = zero;
    *reinterpret_cast<uint4*>(Vs + off) = zero;
    *reinterpret_cast<uint4*>(Os + off) = zero;
  }
  if constexpr (DZ > D) {
    static_assert(DZ - D == 8, "one zero chunk per row");
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      *reinterpret_cast<uint4*>(Qs + t * DP + D) = zero;
      *reinterpret_cast<uint4*>(Ks + t * DP + D) = zero;
      *reinterpret_cast<uint4*>(Vs + t * DP + D) = zero;
      *reinterpret_cast<uint4*>(Os + t * DP + D) = zero;
    }
  }
  for (int i = threadIdx.x; i < 9 * D; i += blockDim.x)
    Tw[i] = bf2f(lepe_w[i / D * cb + hc + i % D]);
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {  // q -> bf16(q·scale)
    uint4* p = reinterpret_cast<uint4*>(Qs + i / CH * DP + i % CH * 8);
    uint4 v = *p;
    v.x = scale_bf16x2(v.x, scale);
    v.y = scale_bf16x2(v.y, scale);
    v.z = scale_bf16x2(v.z, scale);
    v.w = scale_bf16x2(v.w, scale);
    *p = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;

  // A fragments of 16 rows of a staged tile (Q or dO) from row r0, DK k16 steps.
  const auto rows_a = [&](const bf16* T, int r0, uint32_t (&a)[DK][4]) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
      ldsm_x4(a[kk], T + (r0 + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);
  };
  // acc = A·Tᵀ over the window's keys (T = K for the scores, V for dP); n8
  // tiles past the window's padded length stay 0.
  const auto block_product = [&](const uint32_t (&a)[DK][4], const bf16* T,
                                  float (&acc)[KT][4]) {
#pragma unroll
    for (int t2 = 0; t2 < KT / 2; ++t2) {
      const int t = 2 * t2;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = acc[t + 1][e] = 0.f;
      if (t >= nt) continue;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t b4[4];
        ldsm_x4(b4, T + (t * 8 + (lane >> 4) * 8 + (lane & 7)) * DP + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(acc[t], a[kk], b4[0], b4[1]);
        mma_bf16(acc[t + 1], a[kk], b4[2], b4[3]);
      }
    }
  };
  // A warp's 16 rows from row r0 of an output (channels at `off` of the
  // (B·H·W, 3C) dqkv) leave from its staging tile `tile` in 16-byte chunks,
  // rows past L skipped; the fragments were written there by the warp.
  bf16* own = Ow + warp * 2 * 16 * DP;
  const auto store_rows = [&](int tile, int r0, int off) {
    __syncwarp();
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = i % CH * 8;
      if (r0 + r < L)
        *reinterpret_cast<uint4*>(dqkv + pixel(r0 + r) * C3 + off + c) =
            *reinterpret_cast<const uint4*>(own + (tile * 16 + r) * DP + c);
    }
    __syncwarp();
  };
  const auto stage = [&](int tile, int h, int u, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(own + (tile * 16 + g + 8 * h) * DP + 8 * u + 2 * q4) =
        pack_bf16(v0, v1);
  };
  const auto key_ok = [&](int t, int e) { return t * 8 + 2 * q4 + (e & 1) < L; };
  const auto quad_max = [](float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  const auto quad_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };

  // P_b and dS_b for every query slab, and dQ.
  for (int s = warp; s < LP / 16; s += WARPS) {
    const int r0 = s * 16;
    uint32_t qa[DK][4], oa[DK][4];
    rows_a(Qs, r0, qa);
    rows_a(Os, r0, oa);
    float S[KT][4], dP[KT][4];
    block_product(qa, Ks, S);
    block_product(oa, Vs, dP);
    float mx[2] = {-INFINITY, -INFINITY};  // row max
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key_ok(t, e)) mx[e >> 1] = fmaxf(mx[e >> 1], S[t][e]);
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = key_ok(t, e) ? expf(S[t][e] - mx[e >> 1]) : 0.f;
        S[t][e] = ex;
        sum[e >> 1] += ex;
      }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
    float dl[2] = {0.f, 0.f};  // rowsum(dP∘P)
#pragma unroll
    for (int t = 0; t < KT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[t][e] *= inv[e >> 1];  // P, float32
        dl[e >> 1] += dP[t][e] * S[t][e];
      }
    dl[0] = quad_sum(dl[0]);
    dl[1] = quad_sum(dl[1]);
    // P_b and dS_b (rows past L are zero), to shared memory; dS_b stays in
    // S for dQ.
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      if (t >= nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + g + 8 * h;
        const bool row = i < L;
        const float p0 = row ? S[t][2 * h] : 0.f, p1 = row ? S[t][2 * h + 1] : 0.f;
        const uint32_t pb = pack_bf16(p0, p1);
        const uint32_t sb = pack_bf16(p0 * (dP[t][2 * h] - dl[h]), p1 * (dP[t][2 * h + 1] - dl[h]));
        *reinterpret_cast<uint32_t*>(Pb + i * LDP + t * 8 + 2 * q4) = pb;
        *reinterpret_cast<uint32_t*>(Sb + i * LDP + t * 8 + 2 * q4) = sb;
        const float2 sf = unpack_bf16(sb);
        S[t][2 * h] = sf.x;
        S[t][2 * h + 1] = sf.y;
      }
    }
    float dq[DN][4];
#pragma unroll
    for (int u = 0; u < DN; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[u][e] = 0.f;
#pragma unroll
    for (int t2 = 0; t2 < KT / 2; ++t2) {
      const int t = 2 * t2;
      if (t >= nt) continue;
      const uint32_t pa[4] = {pack_bf16(S[t][0], S[t][1]), pack_bf16(S[t][2], S[t][3]),
                              pack_bf16(S[t + 1][0], S[t + 1][1]),
                              pack_bf16(S[t + 1][2], S[t + 1][3])};
      const bf16* krow = Ks + (t * 8 + ((lane >> 3) & 1) * 8 + (lane & 7)) * DP;
#pragma unroll
      for (int u = 0; u + 1 < DN; u += 2) {
        uint32_t kb4[4];
        ldsm_x4<true>(kb4, krow + (u + (lane >> 4)) * 8);
        mma_bf16(dq[u], pa, kb4[0], kb4[1]);
        mma_bf16(dq[u + 1], pa, kb4[2], kb4[3]);
      }
      if constexpr (DN % 2) {
        uint32_t kb2[2];
        ldsm_x2_trans(kb2, krow + (DN - 1) * 8);
        mma_bf16(dq[DN - 1], pa, kb2[0], kb2[1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < DN; ++u) stage(0, h, u, dq[u][2 * h] * scale, dq[u][2 * h + 1] * scale);
    store_rows(0, r0, c0);
  }
  __syncthreads();  // P_b and dS_b are complete

  // dK and dV of the window's 16-key slabs, over all queries.
  for (int js = warp; js < LP / 16; js += WARPS) {
    const int j0 = js * 16;
    float dk[DN][4], dv[DN][4];
#pragma unroll
    for (int u = 0; u < DN; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[u][e] = dv[u][e] = 0.f;
    for (int i0 = 0; i0 < LP; i0 += 16) {
      // A = P_bᵀ, dS_bᵀ (rows keys, columns queries) from the query-major tiles.
      uint32_t ap[4], as[4];
      const int aoff = (i0 + (lane & 7) + (lane >> 4) * 8) * LDP + j0 + ((lane >> 3) & 1) * 8;
      ldsm_x4<true>(ap, Pb + aoff);
      ldsm_x4<true>(as, Sb + aoff);
      const int brow = (i0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * DP;
#pragma unroll
      for (int u = 0; u + 1 < DN; u += 2) {
        uint32_t ob[4], qb[4];
        ldsm_x4<true>(ob, Os + brow + (u + (lane >> 4)) * 8);
        ldsm_x4<true>(qb, Qs + brow + (u + (lane >> 4)) * 8);
        mma_bf16(dv[u], ap, ob[0], ob[1]);
        mma_bf16(dv[u + 1], ap, ob[2], ob[3]);
        mma_bf16(dk[u], as, qb[0], qb[1]);
        mma_bf16(dk[u + 1], as, qb[2], qb[3]);
      }
      if constexpr (DN % 2) {
        uint32_t ob[2], qb[2];
        ldsm_x2_trans(ob, Os + brow + (DN - 1) * 8);
        ldsm_x2_trans(qb, Qs + brow + (DN - 1) * 8);
        mma_bf16(dv[DN - 1], ap, ob[0], ob[1]);
        mma_bf16(dk[DN - 1], as, qb[0], qb[1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + g + 8 * h;
      const int tr = j / w_sp, tc = j % w_sp;  // rows past L are staged, not stored
#pragma unroll
      for (int u = 0; u < DN; ++u) {
        const int dd = 8 * u + 2 * q4;
        float l0 = 0.f, l1 = 0.f;  // the transposed LePE conv of dO
        for (int di = -1; j < L && di <= 1; ++di) {
          const int r = tr - di;
          if (r < 0 || r >= h_sp) continue;
          for (int dj = -1; dj <= 1; ++dj) {
            const int c = tc - dj;
            if (c < 0 || c >= w_sp) continue;
            const float2 w2 = *reinterpret_cast<const float2*>(Tw + ((di + 1) * 3 + dj + 1) * D + dd);
            const float2 o2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(Os + (r * w_sp + c) * DP + dd));
            l0 += w2.x * o2.x;
            l1 += w2.y * o2.y;
          }
        }
        stage(0, h, u, dk[u][2 * h], dk[u][2 * h + 1]);
        stage(1, h, u, dv[u][2 * h] + l0, dv[u][2 * h + 1] + l1);
      }
    }
    store_rows(0, j0, C + c0);
    store_rows(1, j0, 2 * C + c0);
  }

  // LePE weight (9 taps) and bias partials of this (window, head). Lane
  // (channel pair, token group of 8) walks its tokens once, reading dO and
  // the nine neighbours of V, ten independent sums in flight; the eight
  // token groups are then added by shuffles (a fixed order) and written
  // channel-major, (cb, 10) a window: taps 0-8, then the bias.
  {
    const int cp = warp * 4 + q4, dd = 2 * cp;  // channel pair
    if (cp < D / 2) {
      float acc[10][2] = {};
      for (int t = g; t < L; t += 8) {
        const int tr = t / w_sp, tc = t % w_sp;
        const float2 o2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(Os + t * DP + dd));
        acc[9][0] += o2.x;
        acc[9][1] += o2.y;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int r = tr + tap / 3 - 1, c = tc + tap % 3 - 1;
          if (r < 0 || r >= h_sp || c < 0 || c >= w_sp) continue;
          const float2 v2 =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(Vs + (r * w_sp + c) * DP + dd));
          acc[tap][0] += o2.x * v2.x;
          acc[tap][1] += o2.y * v2.y;
        }
      }
#pragma unroll
      for (int tap = 0; tap < 10; ++tap)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1)
            acc[tap][e] += __shfl_xor_sync(__activemask(), acc[tap][e], o);
      if (g == 0) {
        float* dst = dl_part + ((size_t)win * cb + hc + dd) * 10;
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int tap = 0; tap < 10; ++tap) dst[e * 10 + tap] = acc[tap][e];
      }
    }
  }
}

// The row kernel: a CTA takes split_rows_per_cta(L) query rows of a (window,
// head), k and v of the window staged once; each warp takes groups of RG
// rows, one at a time, their q·scale and dO as B fragments straight from
// device memory. Sᵀ = K·(q·scale)ᵀ of every 16-key tile stays in registers
// (the lane holds keys g and g + 8 of each tile for rows 2·q4 and 2·q4 + 1),
// so the rows' max, sum and P come from one product; rowsum(dP∘P) and then
// dS take dPᵀ = V·dOᵀ a tile at a time, twice. dQᵀ = Kᵀ·dS_bᵀ takes dS_b as
// B fragments by transposing its two 8x8 halves across the warp
// (movmatrix). The rows' max, 1 / sum and rowsum(dP∘P) go to the stats
// buffer for the key kernel.
template <int D>
__device__ __forceinline__ void row_part(const BwdArgs& a) {
  static_assert(D % 8 == 0 && D <= 32, "head dims 16, 24, 32");
  constexpr int DP = row_stride<D>();
  constexpr int DK = (D + 15) / 16;  // k16 steps over the head dim; m16 tiles of dQᵀ
  constexpr int CH = D / 8;          // 16-byte chunks of a token's head slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.h_sp * a.w_sp, LP = (L + 15) & ~15, nt = LP / KEY_TILE;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + LP * DP;
  bf16* Ow = Vs + LP * DP;  // per warp: its row group's dQ on the way out

  const int n_wh = a.H / a.h_sp, n_ww = a.W / a.w_sp;
  const int win = blockIdx.x;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * a.h_sp, col0 = win % n_ww * a.w_sp;
  const int head = blockIdx.y;
  const int c0 = a.ch_off + head * D;
  const size_t C3 = 3 * (size_t)a.C;
  const auto pixel = [&](int t) {
    return ((size_t)b * a.H + row0 + t / a.w_sp) * a.W + col0 + t % a.w_sp;
  };

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH * 8;
    const bf16* src = a.qkv + pixel(t) * C3 + c0 + c;
    cp_async16(Ks + t * DP + c, src + a.C);
    cp_async16(Vs + t * DP + c, src + 2 * a.C);
  }
  cp_async_commit();
  zero_padding<D>(Ks, L, LP);
  zero_padding<D>(Vs, L, LP);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int per_cta = a.part / RG;  // row groups of the CTA
  const int g_end = min((int)(blockIdx.z + 1) * per_cta, (L + RG - 1) / RG);
  float* st = a.stats + ((size_t)win * gridDim.y + head) * 3 * LP;
  bf16* own = Ow + warp * RG * DP;
  cp_async_wait<0>();
  __syncthreads();

  for (int grp = blockIdx.z * per_cta + warp; grp < g_end; grp += WARPS) {
    const int r0 = grp * RG;
    // q·scale and dO of row r0 + g as B fragments (k the head dim, n the row)
    uint32_t qb[DK][2], ob[DK][2];
    {
      const bool row = r0 + g < L;
      const size_t m = pixel(row ? r0 + g : 0);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = kk * 16 + h * 8 + 2 * q4;
          const bool in = row && kk * 16 + h * 8 < D;
          qb[kk][h] = in ? scale_bf16x2(ld_u32(a.qkv + m * C3 + c0 + d), a.scale) : 0u;
          ob[kk][h] = in ? ld_u32(a.dout + m * a.C + c0 + d) : 0u;
        }
    }
    // dPᵀ of key tile t: V·dOᵀ
    const auto dp_tile = [&](int t, float (&dp)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t va[4];
        ldsm_x4(va, Vs + (t * KEY_TILE + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);
        mma_bf16(dp, va, ob[kk][0], ob[kk][1]);
      }
    };
    const auto key_ok = [&](int t, int e) { return t * KEY_TILE + g + 8 * (e >> 1) < L; };

    float S[SPLIT_TILES][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < SPLIT_TILES; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) S[t][e] = 0.f;
      if (t < nt) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          uint32_t ka[4];
          ldsm_x4(ka, Ks + (t * KEY_TILE + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);
          mma_bf16(S[t], ka, qb[kk][0], qb[kk][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key_ok(t, e)) mx[e & 1] = fmaxf(mx[e & 1], S[t][e]);
      }
    }
    mx[0] = column_max(mx[0]);
    mx[1] = column_max(mx[1]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < SPLIT_TILES; ++t)
      if (t < nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = key_ok(t, e) ? expf(S[t][e] - mx[e & 1]) : 0.f;
          S[t][e] = ex;
          sum[e & 1] += ex;
        }
    const float inv[2] = {1.f / column_sum(sum[0]), 1.f / column_sum(sum[1])};
    float dl[2] = {0.f, 0.f};  // rowsum(dP∘P)
#pragma unroll
    for (int t = 0; t < SPLIT_TILES; ++t)
      if (t < nt) {
        float dp[4];
        dp_tile(t, dp);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          S[t][e] *= inv[e & 1];  // P, float32
          dl[e & 1] += dp[e] * S[t][e];
        }
      }
    dl[0] = column_sum(dl[0]);
    dl[1] = column_sum(dl[1]);

    // dS = P∘(dP − rowsum(dP∘P)), dS_b = bf16(dS); dQᵀ += Kᵀ·dS_bᵀ over the tiles
    float dq[DK][4];
#pragma unroll
    for (int mt = 0; mt < DK; ++mt) dq[mt][0] = dq[mt][1] = dq[mt][2] = dq[mt][3] = 0.f;
#pragma unroll
    for (int t = 0; t < SPLIT_TILES; ++t)
      if (t < nt) {
        float dp[4];
        dp_tile(t, dp);
        const uint32_t b0 = movmatrix_trans(
            pack_bf16(S[t][0] * (dp[0] - dl[0]), S[t][1] * (dp[1] - dl[1])));
        const uint32_t b1 = movmatrix_trans(
            pack_bf16(S[t][2] * (dp[2] - dl[0]), S[t][3] * (dp[3] - dl[1])));
#pragma unroll
        for (int mt = 0; mt < DK; ++mt) {
          uint32_t ka[4];  // A = Kᵀ: rows the head dim, columns the tile's keys
          ldsm_x4<true>(ka, Ks + (t * KEY_TILE + ((lane >> 4) & 1) * 8 + (lane & 7)) * DP +
                                mt * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(dq[mt], ka, b0, b1);
        }
      }

    // dQ = dQᵀ·scale, rounded once, out through the warp's tile in 16-byte
    // chunks; the rows' statistics (lanes 0-3 hold rows 2·q4 and 2·q4 + 1)
#pragma unroll
    for (int mt = 0; mt < DK; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = mt * 16 + g + 8 * (e >> 1);
        if (d < D) own[(2 * q4 + (e & 1)) * DP + d] = f2bf(dq[mt][e] * a.scale);
      }
    __syncwarp();
    for (int i = lane; i < RG * CH; i += 32) {
      const int r = i / CH, c = i % CH * 8;
      if (r0 + r < L)
        *reinterpret_cast<uint4*>(a.dqkv + pixel(r0 + r) * C3 + c0 + c) =
            *reinterpret_cast<const uint4*>(own + r * DP + c);
    }
    if (g == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = r0 + 2 * q4 + h;
        if (i < L) {
          st[i] = mx[h];
          st[LP + i] = inv[h];
          st[2 * LP + i] = dl[h];
        }
      }
    }
    __syncwarp();  // the tile is rewritten by the warp's next group
  }
}

// The key kernel: a CTA takes split_key_tiles_per_cta(L) tiles of 16 keys
// of a (window, head), a warp each, with q·scale, dO and the rows'
// statistics of the window staged once; the warp's k and v are A fragments
// in registers. It walks the rows in 16-row steps, as the whole-window
// kernel's dK and dV do: Sᵀ = K·(q·scale)ᵀ and dPᵀ = V·dOᵀ, P = exp(S −
// max) · (1 / sum) and dS = P∘(dP − rowsum(dP∘P)) from the statistics, then
// dV += P_bᵀ·dO and dK += dS_bᵀ·(q·scale) with P_b and dS_b repacked from C
// to A fragments in registers. dV gets the LePE transpose conv before its
// one rounding; the LePE weight and bias partials of the CTA's keys go to
// row (window, key CTA) of dl_part. Padded rows read zero statistics: P =
// dS = 0 there.
template <int D>
__device__ __forceinline__ void key_part(const BwdArgs& a) {
  static_assert(D % 8 == 0 && D <= 32, "head dims 16, 24, 32");
  constexpr int DP = row_stride<D>();
  constexpr int DK = (D + 15) / 16;  // k16 steps over the head dim
  constexpr int DN = D / 8;          // n8 tiles over the head dim
  constexpr int CH = D / 8;          // 16-byte chunks of a token's head slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = a.h_sp * a.w_sp, LP = (L + 15) & ~15, nkt = LP / KEY_TILE;
  const int h_sp = a.h_sp, w_sp = a.w_sp;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // q·scale
  bf16* Os = Qs + LP * DP;                       // dO
  float* St = reinterpret_cast<float*>(Os + LP * DP);  // max, 1 / sum, rowsum(dP∘P); LP each
  float* Tw = St + 3 * LP;                              // LePE taps, 9 x D
  bf16* Ow = reinterpret_cast<bf16*>(Tw + 9 * D);       // per warp: dK or dV on the way out

  const int n_wh = a.H / h_sp, n_ww = a.W / w_sp;
  const int win = blockIdx.x;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * h_sp, col0 = win % n_ww * w_sp;
  const int head = blockIdx.y;
  const int hc = head * D, c0 = a.ch_off + hc;
  const size_t C3 = 3 * (size_t)a.C;
  const auto pixel = [&](int t) {
    return ((size_t)b * a.H + row0 + t / w_sp) * a.W + col0 + t % w_sp;
  };

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH * 8;
    const size_t m = pixel(t);
    cp_async16(Qs + t * DP + c, a.qkv + m * C3 + c0 + c);
    cp_async16(Os + t * DP + c, a.dout + m * a.C + c0 + c);
  }
  const float* st_in = a.stats + ((size_t)win * gridDim.y + head) * 3 * LP;
  for (int i = threadIdx.x; i < 3 * LP / 4; i += blockDim.x) cp_async16(St + 4 * i, st_in + 4 * i);
  cp_async_commit();
  zero_padding<D>(Qs, L, LP);
  zero_padding<D>(Os, L, LP);
  for (int i = threadIdx.x; i < 9 * D; i += blockDim.x)
    Tw[i] = bf2f(a.lepe_w[i / D * a.cb + hc + i % D]);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int tile = blockIdx.z * a.part + warp;
  const int j0 = tile * KEY_TILE;
  // k and v of keys j0 + g and j0 + g + 8 as A fragments (m the key, k the head dim)
  uint32_t ka[DK][4], va[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + g + 8 * (r & 1), d = kk * 16 + 8 * (r >> 1) + 2 * q4;
      const bool in = tile < nkt && j < L && kk * 16 + 8 * (r >> 1) < D;
      const size_t m = pixel(in ? j : 0) * C3 + c0 + d;
      ka[kk][r] = in ? ld_u32(a.qkv + m + a.C) : 0u;
      va[kk][r] = in ? ld_u32(a.qkv + m + 2 * a.C) : 0u;
    }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {  // q -> bf16(q·scale)
    uint4* p = reinterpret_cast<uint4*>(Qs + i / CH * DP + i % CH * 8);
    uint4 v = *p;
    v.x = scale_bf16x2(v.x, a.scale);
    v.y = scale_bf16x2(v.y, a.scale);
    v.z = scale_bf16x2(v.z, a.scale);
    v.w = scale_bf16x2(v.w, a.scale);
    *p = v;
  }
  for (int i = L + threadIdx.x; i < LP; i += blockDim.x) St[i] = St[LP + i] = St[2 * LP + i] = 0.f;
  __syncthreads();

  if (tile < nkt) {
    float dk[DN][4], dv[DN][4];
#pragma unroll
    for (int u = 0; u < DN; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[u][e] = dv[u][e] = 0.f;
    for (int i0 = 0; i0 < LP; i0 += 16) {
      // q·scale and dO of rows i0 .. i0 + 15 as B fragments (k the head
      // dim, n the row) of the two n8 row tiles
      uint32_t qb[2][DK][2], ob[2][DK][2];
      if constexpr (DK == 2) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          uint32_t r4[4];
          const int off = (i0 + 8 * n + (lane & 7)) * DP + (lane >> 3) * 8;
          ldsm_x4(r4, Qs + off);
          qb[n][0][0] = r4[0], qb[n][0][1] = r4[1], qb[n][1][0] = r4[2], qb[n][1][1] = r4[3];
          ldsm_x4(r4, Os + off);
          ob[n][0][0] = r4[0], ob[n][0][1] = r4[1], ob[n][1][0] = r4[2], ob[n][1][1] = r4[3];
        }
      } else {
        uint32_t r4[4];
        const int off = (i0 + 8 * (lane >> 4) + (lane & 7)) * DP + ((lane >> 3) & 1) * 8;
        ldsm_x4(r4, Qs + off);
        qb[0][0][0] = r4[0], qb[0][0][1] = r4[1], qb[1][0][0] = r4[2], qb[1][0][1] = r4[3];
        ldsm_x4(r4, Os + off);
        ob[0][0][0] = r4[0], ob[0][0][1] = r4[1], ob[1][0][0] = r4[2], ob[1][0][1] = r4[3];
      }
      uint32_t ap[4], as[4];  // P_bᵀ and dS_bᵀ as A fragments (m the key, k the row)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          mma_bf16(s, ka[kk], qb[n][kk][0], qb[n][kk][1]);
          mma_bf16(dp, va[kk], ob[n][kk][0], ob[n][kk][1]);
        }
        const int i = i0 + 8 * n + 2 * q4;  // the lane's rows i and i + 1
        const float2 m2 = *reinterpret_cast<const float2*>(St + i);
        const float2 v2 = *reinterpret_cast<const float2*>(St + LP + i);
        const float2 l2 = *reinterpret_cast<const float2*>(St + 2 * LP + i);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          p[e] = expf(s[e] - (odd ? m2.y : m2.x)) * (odd ? v2.y : v2.x);
          ds[e] = p[e] * (dp[e] - (odd ? l2.y : l2.x));
        }
        ap[2 * n] = pack_bf16(p[0], p[1]);
        ap[2 * n + 1] = pack_bf16(p[2], p[3]);
        as[2 * n] = pack_bf16(ds[0], ds[1]);
        as[2 * n + 1] = pack_bf16(ds[2], ds[3]);
      }
      const int brow = (i0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * DP;
#pragma unroll
      for (int u = 0; u + 1 < DN; u += 2) {
        uint32_t o4[4], q4b[4];
        ldsm_x4<true>(o4, Os + brow + (u + (lane >> 4)) * 8);
        ldsm_x4<true>(q4b, Qs + brow + (u + (lane >> 4)) * 8);
        mma_bf16(dv[u], ap, o4[0], o4[1]);
        mma_bf16(dv[u + 1], ap, o4[2], o4[3]);
        mma_bf16(dk[u], as, q4b[0], q4b[1]);
        mma_bf16(dk[u + 1], as, q4b[2], q4b[3]);
      }
      if constexpr (DN % 2) {
        uint32_t o2[2], q2[2];
        ldsm_x2_trans(o2, Os + brow + (DN - 1) * 8);
        ldsm_x2_trans(q2, Qs + brow + (DN - 1) * 8);
        mma_bf16(dv[DN - 1], ap, o2[0], o2[1]);
        mma_bf16(dk[DN - 1], as, q2[0], q2[1]);
      }
    }

    // dK, then dV with the transposed LePE conv of dO, out through the
    // warp's tile in 16-byte chunks; rows past L are not stored
    bf16* own = Ow + warp * KEY_TILE * DP;
    const auto store = [&](int off) {
      __syncwarp();
      for (int i = lane; i < KEY_TILE * CH; i += 32) {
        const int r = i / CH, c = i % CH * 8;
        if (j0 + r < L)
          *reinterpret_cast<uint4*>(a.dqkv + pixel(j0 + r) * C3 + off + c) =
              *reinterpret_cast<const uint4*>(own + r * DP + c);
      }
      __syncwarp();
    };
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < DN; ++u)
        *reinterpret_cast<uint32_t*>(own + (g + 8 * h) * DP + 8 * u + 2 * q4) =
            pack_bf16(dk[u][2 * h], dk[u][2 * h + 1]);
    store(a.C + c0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + g + 8 * h;
      const int tr = j / w_sp, tc = j % w_sp;
#pragma unroll
      for (int u = 0; u < DN; ++u) {
        const int dd = 8 * u + 2 * q4;
        float l0 = 0.f, l1 = 0.f;  // the transposed LePE conv of dO
        for (int di = -1; j < L && di <= 1; ++di) {
          const int r = tr - di;
          if (r < 0 || r >= h_sp) continue;
          for (int dj = -1; dj <= 1; ++dj) {
            const int c = tc - dj;
            if (c < 0 || c >= w_sp) continue;
            const float2 w2 = *reinterpret_cast<const float2*>(Tw + ((di + 1) * 3 + dj + 1) * D + dd);
            const float2 o2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(Os + (r * w_sp + c) * DP + dd));
            l0 += w2.x * o2.x;
            l1 += w2.y * o2.y;
          }
        }
        *reinterpret_cast<uint32_t*>(own + (g + 8 * h) * DP + dd) =
            pack_bf16(dv[u][2 * h] + l0, dv[u][2 * h + 1] + l1);
      }
    }
    store(2 * a.C + c0);
  }

  // LePE weight (9 taps) and bias partials of the CTA's keys u: lane
  // (channel pair, token group of 8) adds V[u]·dO[u - tap] and dO[u] over
  // its tokens, ten sums in flight; the eight groups are added by shuffles
  // in a fixed order and written channel-major, (cb, 10) a window and key
  // CTA. The staged dO is all it reads of shared memory: no barrier.
  const int u0 = blockIdx.z * a.part * KEY_TILE, u1 = min(L, u0 + a.part * KEY_TILE);
  const unsigned group = 0x11111111u << q4;  // the lanes of the quad position
  for (int cp = warp * 4 + q4; cp < D / 2; cp += (blockDim.x >> 5) * 4) {
    const int dd = 2 * cp;
    float acc[10][2] = {};
    for (int u = u0 + g; u < u1; u += 8) {
      const int tr = u / w_sp, tc = u % w_sp;
      const float2 v2 = unpack_bf16(ld_u32(a.qkv + pixel(u) * C3 + 2 * a.C + c0 + dd));
      const float2 o2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(Os + u * DP + dd));
      acc[9][0] += o2.x;
      acc[9][1] += o2.y;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int r = tr - (tap / 3 - 1), c = tc - (tap % 3 - 1);
        if (r < 0 || r >= h_sp || c < 0 || c >= w_sp) continue;
        const float2 n2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(Os + (r * w_sp + c) * DP + dd));
        acc[tap][0] += n2.x * v2.x;
        acc[tap][1] += n2.y * v2.y;
      }
    }
#pragma unroll
    for (int tap = 0; tap < 10; ++tap)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) acc[tap][e] += __shfl_xor_sync(group, acc[tap][e], o);
    if (g == 0) {
      float* dst = a.dl_part + (((size_t)win * gridDim.z + blockIdx.z) * a.cb + hc + dd) * 10;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int tap = 0; tap < 10; ++tap) dst[e * 10 + tap] = acc[tap][e];
    }
  }
}

// The split's two kernels: instances of the whole-window kernel's name, so
// that a trace reads all three as one family. Registers for four row-kernel
// CTAs an SM and three key-kernel CTAs of their widest (two at head dim 32,
// whose lane state does not fit 112 registers).
template <int D, int Part>
__global__ void __launch_bounds__(Part == KEY_PART ? KEY_PART_TILES * 32 : WARPS * 32,
                                  Part == ROW_PART ? 4 : D > 24 ? 2 : 3)
stripe_attention_bwd_kernel(const BwdArgs a) {
  static_assert(Part == ROW_PART || Part == KEY_PART, "the split's parts");
  if constexpr (Part == ROW_PART)
    row_part<D>(a);
  else
    key_part<D>(a);
}

template <int D>
cudaError_t launch(const bf16* qkv, const bf16* dout, const bf16* lw, bf16* dqkv,
                   float* dl, int B, int H, int W, int C, int ch_off, int cb, int heads,
                   int h_sp, int w_sp, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(h_sp * w_sp);
  // the whole-window instance among the name's overloads
  void (*kernel)(const bf16*, const bf16*, const bf16*, bf16*, float*, int, int, int, int, int,
                 int, int, float) = stripe_attention_bwd_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (H / h_sp) * (W / w_sp), heads);
  stripe_attention_bwd_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
      qkv, dout, lw, dqkv, dl, H, W, C, ch_off, cb, h_sp, w_sp, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_split(BwdArgs a, int B, int heads, cudaStream_t stream) {
  const int L = a.h_sp * a.w_sp, windows = B * (a.H / a.h_sp) * (a.W / a.w_sp);
  const size_t rows = smem_rows_split<D>(L), keys = smem_keys_split<D>(L);
  void (*row_kernel)(const BwdArgs) = stripe_attention_bwd_kernel<D, ROW_PART>;
  void (*key_kernel)(const BwdArgs) = stripe_attention_bwd_kernel<D, KEY_PART>;
  cudaError_t err = allow_smem(row_kernel, rows);
  if (err == cudaSuccess) err = allow_smem(key_kernel, keys);
  if (err != cudaSuccess) return err;
  a.part = split_rows_per_cta(L);
  stripe_attention_bwd_kernel<D, ROW_PART>
      <<<dim3(windows, heads, (L + a.part - 1) / a.part), WARPS * 32, rows, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = (L + KEY_TILE - 1) / KEY_TILE;
  a.part = split_key_tiles_per_cta(L);
  stripe_attention_bwd_kernel<D, KEY_PART>
      <<<dim3(windows, heads, (tiles + a.part - 1) / a.part), a.part * 32, keys, stream>>>(a);
  return cudaGetLastError();
}

// --- the float32 instance (TPU.COMPUTE_DTYPE float32) ----------------------

constexpr int ROWS_B = 4;       // query rows a warp of the row kernel takes at once
constexpr int ROW_TARGET = 96;  // query rows a row-kernel CTA takes, at most about
constexpr int KEYS = 32;        // keys of a key block, a lane each
constexpr int KEY_BLOCKS = 3;   // key blocks a key-kernel CTA takes, at most

// Query rows of a row-kernel CTA at a window of L tokens: the window in
// ceil(L / ROW_TARGET) near-equal parts, each whole row groups of every
// warp, so that a CTA stages k and v once for about ROW_TARGET rows.
__host__ __device__ constexpr int rows_per_cta(int L) {
  return ((L + (L + ROW_TARGET - 1) / ROW_TARGET - 1) / ((L + ROW_TARGET - 1) / ROW_TARGET) +
          ROWS_B * WARPS - 1) / (ROWS_B * WARPS) * (ROWS_B * WARPS);
}

// Key blocks of a key-kernel CTA: the window's blocks in ceil(blocks /
// KEY_BLOCKS) near-equal parts, so that a CTA stages q and dO once for up
// to KEY_BLOCKS blocks.
__host__ __device__ constexpr int key_blocks_per_cta(int L) {
  return ((L + KEYS - 1) / KEYS + ((L + KEYS - 1) / KEYS + KEY_BLOCKS - 1) / KEY_BLOCKS - 1) /
         (((L + KEYS - 1) / KEYS + KEY_BLOCKS - 1) / KEY_BLOCKS);
}

// Shared memory of the row kernel at a window of L tokens: k and v, and per
// warp two buffers of ROWS_B rows of q·scale and dO and ROWS_B rows of S /
// P and dP / dS over the window's key slots.
template <int D>
__host__ __device__ constexpr size_t smem_rows_f32(int L) {
  return sizeof(float) * (2 * (size_t)L * (D + 4) +
                          (size_t)WARPS * (4 * ROWS_B * D + 2 * ROWS_B * 32 *
                                                                (size_t)attn_tile::key_slots(L)));
}

// Shared memory of the key kernel: q·scale and dO of the window, the rows'
// statistics, the LePE taps, and per warp its key block's v rows.
template <int D>
__host__ __device__ constexpr size_t smem_keys_f32(int L) {
  return sizeof(float) * (2 * (size_t)L * D + 4 * (size_t)L + 9 * D +
                          (size_t)key_blocks_per_cta(L) * KEYS * D);
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32, 2)
stripe_attention_bwd_f32_rows_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                              float* __restrict__ dqkv, float4* __restrict__ stats, int H,
                              int W, int C, int ch_off, int h_sp, int w_sp, float scale) {
  static_assert(D % 8 == 0 && D <= 32, "head dims 16, 24, 32");
  constexpr int KS = D + 4;            // row stride of k and v
  constexpr int CH = D / 4;            // 16-byte chunks of a token's head slice
  constexpr int R = ROWS_B;
  constexpr int CO = D / 8;            // dQ channels a lane writes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = h_sp * w_sp, LS = 32 * attn_tile::key_slots(L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + L * KS;
  float* Wb = Vs + L * KS + warp * (4 * R * D + 2 * R * LS);  // q | dO, two buffers
  float* Sb = Wb + 4 * R * D;                                  // S, then P's numerators
  float* Gb = Sb + R * LS;                                     // dP, then dS

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int win = blockIdx.x;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * h_sp, col0 = win % n_ww * w_sp;
  const int head = blockIdx.y;
  const int c0 = ch_off + head * D;
  const size_t C3 = 3 * (size_t)C;
  const auto pixel = [&](int t) {
    return ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
  };
  float4* st_out = stats + ((size_t)win * gridDim.y + head) * L;

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH * 4;
    const float* src = qkv + pixel(t) * C3 + c0 + c;
    cp_async16(Ks + t * KS + c, src + C);
    cp_async16(Vs + t * KS + c, src + 2 * C);
  }
  cp_async_commit();
  // the warp's groups of R rows: g0, g0 + WARPS, ... inside the CTA's block
  const int per_cta = rows_per_cta(L) / R;
  const int g0 = blockIdx.z * per_cta + warp;
  const int g_end = min((blockIdx.z + 1) * per_cta, (L + R - 1) / R);
  const float* q0 = qkv + pixel(0) * C3 + c0;  // the window's first pixel
  const float* o0 = dout + pixel(0) * C + c0;
  const auto fetch = [&](int g, float* buf) {
    attn_tile::fetch_rows<D, R>(buf, q0, C3, W, w_sp, g * R, L, lane);
    attn_tile::fetch_rows<D, R>(buf + R * D, o0, C, W, w_sp, g * R, L, lane);
  };
  if (g0 < g_end) fetch(g0, Wb);
  cp_async_wait<0>();
  __syncthreads();

  const int cg = lane & 3, kg = lane >> 2;
  for (int g = g0, t = 0; g < g_end; g += WARPS, ++t) {
    float* Q = Wb + (t & 1) * 2 * R * D;
    const float* O = Q + R * D;
    if (t > 0) {
      cp_async_wait<0>();
      __syncwarp();
    }
    for (int i = lane; i < R * D; i += 32) Q[i] *= scale;
    __syncwarp();
    if (g + WARPS < g_end) fetch(g + WARPS, Wb + ((t + 1) & 1) * 2 * R * D);
    float mx[R], sum[R], inv[R], dl[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
    attn_tile::scores<D, R>(Q, Ks, Sb, L, lane, mx);
    attn_tile::scores<D, R, false>(O, Vs, Gb, L, lane, mx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = warp_max(mx[r]);
      sum[r] = dl[r] = 0.f;
    }
    // exp(s - max) in place, its sum and Σ dP·exp(s - max) (rowsum(dP∘P)
    // before the division by the sum), in one pass
    for (int j = lane; j < L; j += 32) {
      float4* p = reinterpret_cast<float4*>(Sb + j * R);
      const float4 d = *reinterpret_cast<const float4*>(Gb + j * R);
      float4 e = *p;
      e.x = expf(e.x - mx[0]);
      e.y = expf(e.y - mx[1]);
      e.z = expf(e.z - mx[2]);
      e.w = expf(e.w - mx[3]);
      *p = e;
      sum[0] += e.x;
      sum[1] += e.y;
      sum[2] += e.z;
      sum[3] += e.w;
      dl[0] = fmaf(d.x, e.x, dl[0]);
      dl[1] = fmaf(d.y, e.y, dl[1]);
      dl[2] = fmaf(d.z, e.z, dl[2]);
      dl[3] = fmaf(d.w, e.w, dl[3]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      inv[r] = 1.f / warp_sum(sum[r]);
      dl[r] = warp_sum(dl[r]) * inv[r];
    }
    for (int j = lane; j < L; j += 32) {  // dS in place
      const float4 e = *reinterpret_cast<const float4*>(Sb + j * R);
      float4* p = reinterpret_cast<float4*>(Gb + j * R);
      const float4 d = *p;
      *p = make_float4((e.x * inv[0]) * (d.x - dl[0]), (e.y * inv[1]) * (d.y - dl[1]),
                       (e.z * inv[2]) * (d.z - dl[2]), (e.w * inv[3]) * (d.w - dl[3]));
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane == r && g * R + r < L) st_out[g * R + r] = make_float4(mx[r], inv[r], dl[r], 0.f);
    __syncwarp();
    float o[CO];
    attn_tile::products<D, R>(Gb, Ks, L, lane, o);
    const int i = g * R + attn_tile::row_of<R>(lane);
    if (i < L) {
      float* dst = dqkv + pixel(i) * C3 + c0 + cg * (D / 4) + (kg & 1) * CO;
#pragma unroll
      for (int u = 0; u < CO; ++u) dst[u] = o[u] * scale;
    }
    __syncwarp();  // the group's rows are rewritten by the next
  }
}

// The key kernel's query row i: q·scale and dO into registers (the same
// address in every lane), and the row's statistics returned.
template <int D>
__device__ __forceinline__ float4 key_row(const float* Qs, const float* Os, const float4* St,
                                          int i, float (&qi)[D], float (&oi)[D]) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 q4 = *reinterpret_cast<const float4*>(Qs + i * D + d);
    const float4 o4 = *reinterpret_cast<const float4*>(Os + i * D + d);
    qi[d] = q4.x, qi[d + 1] = q4.y, qi[d + 2] = q4.z, qi[d + 3] = q4.w;
    oi[d] = o4.x, oi[d + 1] = o4.y, oi[d + 2] = o4.z, oi[d + 3] = o4.w;
  }
  return St[i];
}

// One (row, key) pair of the key kernel: S and dP as two fmaf chains each
// (even and odd d), added; P from the row's statistics (max, 1 / sum) and
// dS = P·(dP − rowsum(dP∘P)); P = dS = 0 past the window.
template <int D>
__device__ __forceinline__ void key_pair(const float (&qi)[D], const float (&oi)[D],
                                         const float (&kr)[D], const float (&vr)[D], float4 st,
                                         bool key, float& p, float& ds) {
  float s0 = 0.f, s1 = 0.f, g0 = 0.f, g1 = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 2) {
    s0 = fmaf(qi[d], kr[d], s0);
    s1 = fmaf(qi[d + 1], kr[d + 1], s1);
    g0 = fmaf(oi[d], vr[d], g0);
    g1 = fmaf(oi[d + 1], vr[d + 1], g1);
  }
  // no branch on the key: a key past the window scores the window's last
  // row and its P is scaled by 0 (a branch here serialises the chains)
  p = expf((s0 + s1) - st.x) * (key ? st.y : 0.f);
  ds = p * ((g0 + g1) - st.z);
}

// Three CTAs an SM at head dims up to 24 (k, v, dK, dV and two rows' q and
// dO of a lane fit 168 registers); two at 32, so that its lane state does not
// spill.
template <int D>
__global__ void __launch_bounds__(KEY_BLOCKS * 32, D <= 24 ? 3 : 2)
stripe_attention_bwd_f32_keys_kernel(const float* __restrict__ qkv,
                                     const float* __restrict__ dout,
                                     const float* __restrict__ lepe_w, float* __restrict__ dqkv,
                                     float* __restrict__ dl_part,
                                     const float4* __restrict__ stats, int H, int W, int C,
                                     int ch_off, int cb, int h_sp, int w_sp, float scale) {
  static_assert(D % 8 == 0 && D <= 32, "head dims 16, 24, 32");
  constexpr int CH = D / 4;  // 16-byte chunks of a token's head slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = h_sp * w_sp;
  float* Qs = reinterpret_cast<float*>(smem_raw);      // q·scale, L x D
  float* Os = Qs + L * D;                              // dO, L x D
  float4* St = reinterpret_cast<float4*>(Os + L * D);  // max, 1 / sum, rowsum(dP∘P)
  float* Tw = reinterpret_cast<float*>(St + L);        // LePE taps, 9 x D

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int win = blockIdx.x;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * h_sp, col0 = win % n_ww * w_sp;
  const int head = blockIdx.y;
  const int hc = head * D;
  const int c0 = ch_off + hc;
  const int nkb = (L + KEYS - 1) / KEYS;
  const size_t C3 = 3 * (size_t)C;
  const auto pixel = [&](int t) {
    return ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
  };
  const float4* st_in = stats + ((size_t)win * gridDim.y + head) * L;

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH * 4;
    const size_t m = pixel(t);
    cp_async16(Qs + t * D + c, qkv + m * C3 + c0 + c);
    cp_async16(Os + t * D + c, dout + m * C + c0 + c);
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) cp_async16(St + i, st_in + i);
  cp_async_commit();
  for (int i = threadIdx.x; i < 9 * D; i += blockDim.x) Tw[i] = lepe_w[i / D * cb + hc + i % D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The warp's key block; lane l holds key kb·KEYS + l: its k and v, and its
  // dK and dV sums over every row of the window.
  const int kb = blockIdx.z * (blockDim.x >> 5) + warp;
  const int j = kb * KEYS + lane;
  const bool key = j < L;
  float kr[D], vr[D], dk[D], dv[D];
  if (kb < nkb) {
    const float* src = qkv + pixel(key ? j : L - 1) * C3 + c0;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = __ldg(reinterpret_cast<const float4*>(src + C + d));
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(src + 2 * C + d));
      kr[d] = k4.x, kr[d + 1] = k4.y, kr[d + 2] = k4.z, kr[d + 3] = k4.w;
      vr[d] = v4.x, vr[d + 1] = v4.y, vr[d + 2] = v4.z, vr[d + 3] = v4.w;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < L * D / 4; i += blockDim.x) {  // q -> q·scale
    float4* p = reinterpret_cast<float4*>(Qs) + i;
    float4 q4 = *p;
    q4.x *= scale;
    q4.y *= scale;
    q4.z *= scale;
    q4.w *= scale;
    *p = q4;
  }
  __syncthreads();
  if (kb >= nkb) return;  // a last CTA's spare warp; no barrier follows

#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;
  int i = 0;
  if constexpr (D <= 24) {  // rows i and i + 1 together: twice the chains in flight
    for (; i + 1 < L; i += 2) {
      float qa[D], oa[D], qb[D], ob[D], pa, dsa, pb, dsb;
      const float4 sa = key_row(Qs, Os, St, i, qa, oa);
      const float4 sb = key_row(Qs, Os, St, i + 1, qb, ob);
      key_pair(qa, oa, kr, vr, sa, key, pa, dsa);
      key_pair(qb, ob, kr, vr, sb, key, pb, dsb);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk[d] = fmaf(dsb, qb[d], fmaf(dsa, qa[d], dk[d]));
        dv[d] = fmaf(pb, ob[d], fmaf(pa, oa[d], dv[d]));
      }
    }
  }
  for (; i < L; ++i) {
    float qi[D], oi[D], p, ds;
    const float4 st = key_row(Qs, Os, St, i, qi, oi);
    key_pair(qi, oi, kr, vr, st, key, p, ds);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[d] = fmaf(ds, qi[d], dk[d]);
      dv[d] = fmaf(p, oi[d], dv[d]);
    }
  }

  // The block's v rows for the LePE partials below; dV gets the LePE
  // transpose conv of dO at the key; dK and dV leave in 16-byte chunks.
  float* Vw = Tw + 9 * D + warp * KEYS * D;
  if (key) {
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(Vw + lane * D + d) =
          make_float4(vr[d], vr[d + 1], vr[d + 2], vr[d + 3]);
    float lp[D];
#pragma unroll
    for (int d = 0; d < D; ++d) lp[d] = 0.f;
    const int tr = j / w_sp, tc = j % w_sp;
    for (int di = -1; di <= 1; ++di) {
      const int r = tr - di;
      if (r < 0 || r >= h_sp) continue;
      for (int dj = -1; dj <= 1; ++dj) {
        const int c = tc - dj;
        if (c < 0 || c >= w_sp) continue;
        const float* w = Tw + ((di + 1) * 3 + dj + 1) * D;
        const float* o = Os + (r * w_sp + c) * D;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(w + d);
          const float4 o4 = *reinterpret_cast<const float4*>(o + d);
          lp[d] = fmaf(w4.x, o4.x, lp[d]);
          lp[d + 1] = fmaf(w4.y, o4.y, lp[d + 1]);
          lp[d + 2] = fmaf(w4.z, o4.z, lp[d + 2]);
          lp[d + 3] = fmaf(w4.w, o4.w, lp[d + 3]);
        }
      }
    }
    float* dst = dqkv + pixel(j) * C3 + c0;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      *reinterpret_cast<float4*>(dst + C + d) = make_float4(dk[d], dk[d + 1], dk[d + 2], dk[d + 3]);
      *reinterpret_cast<float4*>(dst + 2 * C + d) = make_float4(
          dv[d] + lp[d], dv[d + 1] + lp[d + 1], dv[d + 2] + lp[d + 2], dv[d + 3] + lp[d + 3]);
    }
  }
  __syncwarp();

  // LePE weight (9 taps) and bias partials of the block's tokens t: lane
  // (channel pair cp = lane % 16, token parity) adds V[t]·dO[t - tap] and
  // dO[t] over its sixteen tokens, ten sums in flight; the two parities are
  // added by a shuffle and written channel-major, (cb, 10) a window and key
  // block.
  const int cp = lane & 15, dd = 2 * cp;
  if (cp < D / 2) {
    float acc[10][2] = {};
    for (int t = kb * KEYS + (lane >> 4); t < min(L, (kb + 1) * KEYS); t += 2) {
      const int tr = t / w_sp, tc = t % w_sp;
      const float2 o2 = *reinterpret_cast<const float2*>(Os + t * D + dd);
      const float2 v2 = *reinterpret_cast<const float2*>(Vw + (t - kb * KEYS) * D + dd);
      acc[9][0] += o2.x;
      acc[9][1] += o2.y;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int r = tr - (tap / 3 - 1), c = tc - (tap % 3 - 1);
        if (r < 0 || r >= h_sp || c < 0 || c >= w_sp) continue;
        const float2 n2 = *reinterpret_cast<const float2*>(Os + (r * w_sp + c) * D + dd);
        acc[tap][0] = fmaf(n2.x, v2.x, acc[tap][0]);
        acc[tap][1] = fmaf(n2.y, v2.y, acc[tap][1]);
      }
    }
#pragma unroll
    for (int tap = 0; tap < 10; ++tap)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[tap][e] += __shfl_xor_sync(__activemask(), acc[tap][e], 16);
    if (lane < 16) {
      float* dst = dl_part + (((size_t)win * nkb + kb) * cb + hc + dd) * 10;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int tap = 0; tap < 10; ++tap) dst[e * 10 + tap] = acc[tap][e];
    }
  }
}

template <int D>
cudaError_t launch_f32(const float* qkv, const float* dout, const float* lw, float* dqkv,
                       float* dl, float4* stats, int B, int H, int W, int C, int ch_off, int cb,
                       int heads, int h_sp, int w_sp, float scale, cudaStream_t stream) {
  const int L = h_sp * w_sp, windows = B * (H / h_sp) * (W / w_sp);
  const size_t rows = smem_rows_f32<D>(L), keys = smem_keys_f32<D>(L);
  cudaError_t err = allow_smem(stripe_attention_bwd_f32_rows_kernel<D>, rows);
  if (err == cudaSuccess) err = allow_smem(stripe_attention_bwd_f32_keys_kernel<D>, keys);
  if (err != cudaSuccess) return err;
  const int row_ctas = (L + rows_per_cta(L) - 1) / rows_per_cta(L);
  const int per_cta = key_blocks_per_cta(L);  // a warp a key block
  const int key_ctas = ((L + KEYS - 1) / KEYS + per_cta - 1) / per_cta;
  stripe_attention_bwd_f32_rows_kernel<D><<<dim3(windows, heads, row_ctas), WARPS * 32, rows,
                                            stream>>>(qkv, dout, dqkv, stats, H, W, C, ch_off,
                                                      h_sp, w_sp, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  stripe_attention_bwd_f32_keys_kernel<D><<<dim3(windows, heads, key_ctas), per_cta * 32, keys,
                                            stream>>>(qkv, dout, lw, dqkv, dl, stats, H, W, C,
                                                      ch_off, cb, h_sp, w_sp, scale);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory the whole-window kernel takes for a window of L
// tokens at head dim D (16, 24 or 32; else 0; 0 past one key block too):
// what kernels.stripe_attention_bwd_smem computes, for holding the two to
// one another on the card.
CSWIN_API long long cswin_stripe_attention_bwd_smem(int L, int D) {
  switch (D) {
    case 16: return (long long)smem_bytes<16>(L);
    case 24: return (long long)smem_bytes<24>(L);
    case 32: return (long long)smem_bytes<32>(L);
    default: return 0;
  }
}

// qkv: (B, H, W, 3C) bf16; dout: (B, H, W, C) bf16; lepe_w: (9, cb) bf16
// (tap-major, tap = di·3 + dj); dqkv: (B, H, W, 3C) bf16, written at
// channels [ch_off, ch_off + cb) of each third; dl_part: (windows, cb, 10)
// float32, per channel the LePE weight partials of taps 0-8, then the bias
// partial. head_dim = cb / heads must be 16, 24 or 32; C, ch_off
// multiples of 8 and qkv, dout, dqkv 16-byte aligned (16-byte copies).
// The whole window in one CTA: the route of windows of up to one key block
// (L <= 64); a longer one is refused (cudaErrorInvalidValue).
CSWIN_API int cswin_stripe_attention_bwd(const void* qkv, const void* dout,
                                         const void* lepe_w, void* dqkv, void* dl_part,
                                         int B, int H, int W, int C, int ch_off, int cb,
                                         int heads, int h_sp, int w_sp, float scale,
                                         void* stream) {
  const bf16* q = (const bf16*)qkv;
  const bf16* o = (const bf16*)dout;
  const bf16* lw = (const bf16*)lepe_w;
  bf16* g = (bf16*)dqkv;
  float* dl = (float*)dl_part;
  cudaStream_t s = (cudaStream_t)stream;
  if (h_sp * w_sp > KB) return (int)cudaErrorInvalidValue;
  switch (cb / heads) {
    case 16: return (int)launch<16>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 24: return (int)launch<24>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 32: return (int)launch<32>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The split route (windows longer than one key block, up to SPLIT_TILES
// key tiles), two launches on the stream: the tensors as above, but
// dl_part (windows · key CTAs, cb, 10) float32, a row a window and key-kernel
// CTA; stats (windows, heads, 3, LP) float32 scratch between the two
// kernels (LP = L rounded up to 16), 16-byte aligned.
CSWIN_API int cswin_stripe_attention_bwd_split(const void* qkv, const void* dout,
                                               const void* lepe_w, void* dqkv, void* dl_part,
                                               void* stats, int B, int H, int W, int C,
                                               int ch_off, int cb, int heads, int h_sp,
                                               int w_sp, float scale, void* stream) {
  if (h_sp * w_sp > SPLIT_TILES * KEY_TILE) return (int)cudaErrorInvalidValue;
  const BwdArgs a{(const bf16*)qkv, (const bf16*)dout, (const bf16*)lepe_w, (bf16*)dqkv,
                  (float*)dl_part, (float*)stats, H, W, C, ch_off, cb, h_sp, w_sp, scale, 0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cb / heads) {
    case 16: return (int)launch_split<16>(a, B, heads, s);
    case 24: return (int)launch_split<24>(a, B, heads, s);
    case 32: return (int)launch_split<32>(a, B, heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 plan at a window of L tokens, head dim D (16, 24 or 32): what = 0
// the route (1 the split, 0 the whole window), 1 the row kernel's shared
// memory (smem_rows_split), 2 the key kernel's (smem_keys_split), 3 the
// rows of a row-kernel CTA (split_rows_per_cta), 4 the key tiles of a
// key-kernel CTA (split_key_tiles_per_cta); else 0.
CSWIN_API long long cswin_stripe_attention_bwd_plan(int L, int D, int what) {
  if (D != 16 && D != 24 && D != 32) return 0;
  switch (what) {
    case 0: return (L + 15) / 16 * 16 > KB ? 1 : 0;
    case 1: return (long long)(D == 16 ? smem_rows_split<16>(L)
                               : D == 24 ? smem_rows_split<24>(L) : smem_rows_split<32>(L));
    case 2: return (long long)(D == 16 ? smem_keys_split<16>(L)
                               : D == 24 ? smem_keys_split<24>(L) : smem_keys_split<32>(L));
    case 3: return split_rows_per_cta(L);
    case 4: return split_key_tiles_per_cta(L);
    default: return 0;
  }
}

// The float32 instance's plan at a window of L tokens, head dim D: what = 0
// the row kernel's shared memory (smem_rows_f32), 1 the key kernel's
// (smem_keys_f32), 2 the rows of a row-kernel CTA (rows_per_cta), 3 the key
// blocks of a key-kernel CTA (key_blocks_per_cta); else 0.
CSWIN_API long long cswin_stripe_attention_bwd_f32_smem(int L, int D, int what) {
  if (what == 2) return rows_per_cta(L);
  if (what == 3) return key_blocks_per_cta(L);
  if (what != 0 && what != 1) return 0;
  switch (D) {
    case 16: return (long long)(what ? smem_keys_f32<16>(L) : smem_rows_f32<16>(L));
    case 24: return (long long)(what ? smem_keys_f32<24>(L) : smem_rows_f32<24>(L));
    case 32: return (long long)(what ? smem_keys_f32<32>(L) : smem_rows_f32<32>(L));
    default: return 0;
  }
}

// The float32 instance, two launches on the stream: qkv, dout, dqkv
// float32, lepe_w (9, cb) float32; dl_part (windows · key blocks, cb, 10)
// float32, key blocks of KEYS tokens, laid out as above; stats (windows,
// heads, L) float4 scratch between the two kernels; C and ch_off multiples
// of 4 and qkv, dout, dqkv, stats 16-byte aligned; both kernels' shared
// memory at most 227 KB (checked by the wrapper).
CSWIN_API int cswin_stripe_attention_bwd_f32(const void* qkv, const void* dout,
                                             const void* lepe_w, void* dqkv, void* dl_part,
                                             void* stats, int B, int H, int W, int C,
                                             int ch_off, int cb, int heads, int h_sp,
                                             int w_sp, float scale, void* stream) {
  const float* q = (const float*)qkv;
  const float* o = (const float*)dout;
  const float* lw = (const float*)lepe_w;
  float* g = (float*)dqkv;
  float* dl = (float*)dl_part;
  float4* st = (float4*)stats;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cb / heads) {
    case 16: return (int)launch_f32<16>(q, o, lw, g, dl, st, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 24: return (int)launch_f32<24>(q, o, lw, g, dl, st, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 32: return (int)launch_f32<32>(q, o, lw, g, dl, st, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
