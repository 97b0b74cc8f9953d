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
// Σ_t dO[t][c] (the wrapper sums them over windows, one reduction). dQ, dK
// and dV land in bf16 at the branch's channel offset of the q, k and v thirds of a
// (B, H, W, 3C) dqkv buffer, so both branches of a block fill one buffer
// that feeds the qkv weight-gradient and dX products directly.
//
// Replaces: the attention + LePE part of the TPU block backward,
//   cswin_unet_tpu/ops/pallas/cswin_block.py::_block_bwd_kernel_xt, i.e.
//   _attn_windows_bwd (:617-661) and _lepe_windows_bwd (:753-800). The port
//   has one NHWC layout, so there is no transposed (xt) copy of the vertical
//   branch and no column un-split of dW_qkv afterwards.
// Bound on the H100: many tiny problems (L = 56 at the trained stages, d =
//   32): five L x L x d products a (window, head) on 14·d bytes a token, so
//   bytes bound the card's time, and latency and launch shape set the
//   kernel's.
// Design (tensor cores; the roundings of the function, not of its sums),
//   after the forward tile (attention_tile.cuh):
//   * staging: q, k, v and dO of the (window, head) land in shared memory
//     as bf16 through 16-byte cp.async copies, rows padded for ldmatrix, L
//     padded to a multiple of 16 with zero rows and D = 24 to a depth of 32
//     with zero columns; q is then scaled and rounded to bf16 in place (the
//     q·scale that both S and dK use).
//   * each warp owns 16-query slabs. S = Q·Kᵀ and dP = dO·Vᵀ run on
//     mma.sync m16n8k16 (bf16 in, float32 out) over a key block of 64 keys,
//     padded keys masked to -inf; the softmax, the row sum of dP∘P and dS
//     run on the accumulator fragments (a row lives in one quad of lanes:
//     two shuffles a reduction); P = exp(s - max) · (1 / sum), one division
//     a row (no rounding point of the function lies there). dQ = dS_b·K takes dS_b repacked from C to
//     A fragments and K through ldmatrix.trans, in registers.
//   * dK and dV contract over queries, which span warps: P_b and dS_b of
//     the key block go to shared memory as bf16 tiles (LP x 64, 18 KB at L
//     = 56; no L x L float32 tile), and after one barrier each warp owns
//     16-key slabs, dK = dS_bᵀ·Q and dV = P_bᵀ·dO with both operands through
//     ldmatrix.trans; the LePE transpose conv is added in the accumulator
//     layout before dV's rounding. dQ, dK and dV leave through a per-warp
//     staging tile in 16-byte row chunks (whole sectors; stores straight
//     from the fragments write eight rows' half sectors).
//   * windows longer than one key block (base-384's 288 tokens) take, per
//     query slab, three passes over the key blocks for the row max, the sum
//     and rowsum(dP∘P) (kept in shared memory), then one pass per key block
//     as above, dQ accumulated in shared memory across blocks: P is the same
//     rounding of the same softmax, with no online rescale. smem_bytes(L)
//     fits 227 KB up to L = 288 at d = 32, 304 at d = 24.
//   * the LePE weight and bias partials come last: a lane per (channel pair,
//     token group of 8) with all ten sums in flight, the groups added by
//     shuffles.
//
// The float32 instance (cswin_stripe_attention_bwd_f32, TPU.COMPUTE_DTYPE
// float32) computes the same function with nothing rounded: S = q·scale·Kᵀ,
// P = softmax(S), dV = Pᵀ·dO + the LePE transpose conv, dS = P∘(dP −
// rowsum(dP∘P)), dQ = dS·K·scale, dK = dSᵀ·(q·scale), with float32 LePE
// taps. Its products are FFMA (no tensor-core format keeps float32's), and
// the bf16 plan's shared memory does not carry over: float32 q, k, v and dO
// of a 288-token window at d = 24 take 110 KB, and P and dS tiles of a
// 64-key block over all 288 queries 147 KB more. So it splits the work
// another way, with no L x L or L x key-block tile at all:
//   * rows: each warp takes QR = 4 query rows at a time, as the forward's
//     float32 tile does: their scores and dP rows (a lane per key, from
//     16-byte reads of q, dO and of k, v at a row stride of d + 4) into the
//     warp's two row buffers, the softmax's max and sum and rowsum(dP∘P) as
//     warp reductions, P and dS in place, then dQ (a lane per output) from
//     the dS rows and K, written to dqkv; the rows' max, sum and
//     rowsum(dP∘P) go to shared memory.
//   * keys, 32 at a time: lane l holds key j = 32·kb + l's k and v in
//     registers, and warp w walks the rows i ≡ w (mod 4): it recomputes S_ij
//     and dP_ij in the rows' order of operations (so P_ij is the rows'
//     value, bit for bit), forms P_ij and dS_ij from the saved statistics,
//     and adds dS_ij·q_i and P_ij·dO_i into the key's dK and dV in
//     registers. The four warps' partials are added in warp order through
//     shared memory, dV gets the LePE transpose conv, and both leave in
//     16-byte row chunks.
//   That recomputes S and dP once (7·d FMAs a pair, against 5·d at least)
//   for shared memory that grows with L·d only: 158 KB at L = 288, d = 24
//   (smem_bytes_f32; kernels.stripe_attention_bwd_f32_smem mirrors it).
//   * the LePE partials as the bf16 instance's, from float32 dO and V.

#include "common.cuh"

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

// Shared memory of one (window, head); kernels.stripe_attention_bwd_smem
// mirrors it: q, k, v, dO; P_b and dS_b of a key block; each warp's two
// 16-row output tiles; the LePE taps; beyond one key block also the row
// statistics and the dQ accumulators.
template <int D>
__host__ __device__ constexpr size_t smem_bytes(int L) {
  const int LP = (L + 15) / 16 * 16;
  return (size_t)4 * LP * row_stride<D>() * sizeof(bf16) +
         (size_t)2 * LP * LDP * sizeof(bf16) +
         (size_t)WARPS * 2 * 16 * row_stride<D>() * sizeof(bf16) +
         (size_t)9 * D * sizeof(float) +
         (LP > KB ? (size_t)LP * (3 + D) * sizeof(float) : 0);
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
  const int nt = LP / 8, nkb = (nt + KT - 1) / KT;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + LP * DP;
  bf16* Vs = Ks + LP * DP;
  bf16* Os = Vs + LP * DP;  // dO
  bf16* Pb = Os + LP * DP;  // P_b of the key block, LP x KB
  bf16* Sb = Pb + LP * LDP; // dS_b of the key block
  bf16* Ow = Sb + LP * LDP; // per warp: two 16-row output tiles on their way out
  float* Tw = reinterpret_cast<float*>(Ow + WARPS * 2 * 16 * DP);  // LePE taps, 9 x D
  float* Mx = Tw + 9 * D;   // beyond one key block: row max, 1 / sum, rowsum(dP∘P)
  float* Iv = Mx + LP;
  float* Dl = Iv + LP;
  float* Qa = Dl + LP;      // and the dQ accumulators, LP x D

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
  // acc = A·Tᵀ over key block kb (T = K for the scores, V for dP); n8 tiles
  // past the window's padded length stay 0.
  const auto block_product = [&](const uint32_t (&a)[DK][4], const bf16* T, int kb,
                                  float (&acc)[KT][4]) {
#pragma unroll
    for (int t2 = 0; t2 < KT / 2; ++t2) {
      const int t = kb * KT + 2 * t2;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[2 * t2][e] = acc[2 * t2 + 1][e] = 0.f;
      if (t >= nt) continue;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t b4[4];
        ldsm_x4(b4, T + (t * 8 + (lane >> 4) * 8 + (lane & 7)) * DP + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * t2], a[kk], b4[0], b4[1]);
        mma_bf16(acc[2 * t2 + 1], a[kk], b4[2], b4[3]);
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
  const auto key_ok = [&](int kb, int t, int e) { return (kb * KT + t) * 8 + 2 * q4 + (e & 1) < L; };
  const auto quad_max = [](float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  const auto quad_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };

  // Beyond one key block: the row statistics, per query slab, in passes.
  if (nkb > 1) {
    for (int s = warp; s < LP / 16; s += WARPS) {
      const int r0 = s * 16;
      uint32_t qa[DK][4], oa[DK][4];
      rows_a(Qs, r0, qa);
      rows_a(Os, r0, oa);
      float S[KT][4], dP[KT][4];
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
      for (int kb = 0; kb < nkb; ++kb) {
        block_product(qa, Ks, kb, S);
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key_ok(kb, t, e)) mx[e >> 1] = fmaxf(mx[e >> 1], S[t][e]);
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      for (int kb = 0; kb < nkb; ++kb) {
        block_product(qa, Ks, kb, S);
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key_ok(kb, t, e)) sum[e >> 1] += expf(S[t][e] - mx[e >> 1]);
      }
      const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
      for (int kb = 0; kb < nkb; ++kb) {
        block_product(qa, Ks, kb, S);
        block_product(oa, Vs, kb, dP);
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key_ok(kb, t, e))
              dl[e >> 1] += dP[t][e] * (expf(S[t][e] - mx[e >> 1]) * inv[e >> 1]);
      }
      dl[0] = quad_sum(dl[0]);
      dl[1] = quad_sum(dl[1]);
      if (q4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          Mx[r0 + g + 8 * h] = mx[h];
          Iv[r0 + g + 8 * h] = inv[h];
          Dl[r0 + g + 8 * h] = dl[h];
        }
      }
    }
    __syncwarp();  // each slab's statistics are read back by the warp that wrote them
  }

  for (int kb = 0; kb < nkb; ++kb) {
    // P_b and dS_b of this key block for every query slab, and dQ.
    for (int s = warp; s < LP / 16; s += WARPS) {
      const int r0 = s * 16;
      uint32_t qa[DK][4], oa[DK][4];
      rows_a(Qs, r0, qa);
      rows_a(Os, r0, oa);
      float S[KT][4], dP[KT][4];
      block_product(qa, Ks, kb, S);
      block_product(oa, Vs, kb, dP);
      float mx[2], inv[2], dl[2];  // row max, 1 / row sum, rowsum(dP∘P)
      if (nkb == 1) {
        mx[0] = mx[1] = -INFINITY;
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key_ok(0, t, e)) mx[e >> 1] = fmaxf(mx[e >> 1], S[t][e]);
        mx[0] = quad_max(mx[0]);
        mx[1] = quad_max(mx[1]);
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = key_ok(0, t, e) ? expf(S[t][e] - mx[e >> 1]) : 0.f;
            S[t][e] = ex;
            sum[e >> 1] += ex;
          }
        inv[0] = 1.f / quad_sum(sum[0]);
        inv[1] = 1.f / quad_sum(sum[1]);
        dl[0] = dl[1] = 0.f;
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            S[t][e] *= inv[e >> 1];  // P, float32
            dl[e >> 1] += dP[t][e] * S[t][e];
          }
        dl[0] = quad_sum(dl[0]);
        dl[1] = quad_sum(dl[1]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = Mx[r0 + g + 8 * h];
          inv[h] = Iv[r0 + g + 8 * h];
          dl[h] = Dl[r0 + g + 8 * h];
        }
#pragma unroll
        for (int t = 0; t < KT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            S[t][e] = key_ok(kb, t, e) ? expf(S[t][e] - mx[e >> 1]) * inv[e >> 1] : 0.f;
      }
      // P_b and dS_b (rows past L are zero), to shared memory; dS_b stays
      // in S for dQ.
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (kb * KT + t >= nt) continue;
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
        for (int e = 0; e < 4; ++e)
          dq[u][e] = kb == 0 ? 0.f : Qa[(r0 + g + 8 * (e >> 1)) * D + 8 * u + 2 * q4 + (e & 1)];
#pragma unroll
      for (int t2 = 0; t2 < KT / 2; ++t2) {
        const int t = kb * KT + 2 * t2;
        if (t >= nt) continue;
        const uint32_t pa[4] = {pack_bf16(S[2 * t2][0], S[2 * t2][1]),
                                pack_bf16(S[2 * t2][2], S[2 * t2][3]),
                                pack_bf16(S[2 * t2 + 1][0], S[2 * t2 + 1][1]),
                                pack_bf16(S[2 * t2 + 1][2], S[2 * t2 + 1][3])};
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
      if (kb + 1 < nkb) {
#pragma unroll
        for (int u = 0; u < DN; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Qa[(r0 + g + 8 * (e >> 1)) * D + 8 * u + 2 * q4 + (e & 1)] = dq[u][e];
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < DN; ++u) stage(0, h, u, dq[u][2 * h] * scale, dq[u][2 * h + 1] * scale);
        store_rows(0, r0, c0);
      }
    }
    __syncthreads();  // the key block's P_b and dS_b are complete

    // dK and dV of the key block's 16-key slabs, over all queries.
    const int kbase = kb * KB, kn = min(KB, LP - kbase);
    for (int js = warp; js < kn / 16; js += WARPS) {
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
        const int j = kbase + j0 + g + 8 * h;
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
      store_rows(0, kbase + j0, C + c0);
      store_rows(1, kbase + j0, 2 * C + c0);
    }
    if (kb + 1 < nkb) __syncthreads();  // before the next block overwrites P_b and dS_b
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

template <int D>
cudaError_t launch(const bf16* qkv, const bf16* dout, const bf16* lw, bf16* dqkv,
                   float* dl, int B, int H, int W, int C, int ch_off, int cb, int heads,
                   int h_sp, int w_sp, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(h_sp * w_sp);
  cudaError_t err = allow_smem(stripe_attention_bwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (H / h_sp) * (W / w_sp), heads);
  stripe_attention_bwd_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
      qkv, dout, lw, dqkv, dl, H, W, C, ch_off, cb, h_sp, w_sp, scale);
  return cudaGetLastError();
}

// --- the float32 instance (TPU.COMPUTE_DTYPE float32) ----------------------

constexpr int QR = 4;   // query rows a warp takes at once in the row phase
constexpr int KEYS = 32;  // keys of the key phase's block, a lane each

__host__ __device__ constexpr int p_stride_f32(int L) { return (L + 3) / 4 * 4; }

// Shared memory of one (window, head) at float32: q·scale and dO at a row
// stride of D, k and v at D + 4; the rows' statistics (float4: max, sum,
// rowsum(dP∘P)); the LePE taps; then one region the two phases take in
// turn: the row phase's per-warp S / P and dP / dS rows, the key phase's
// per-warp dK | dV partials and the summed rows on their way out.
template <int D>
__host__ __device__ constexpr size_t smem_bytes_f32(int L) {
  const size_t rows = (size_t)WARPS * QR * 2 * p_stride_f32(L);
  const size_t keys = (size_t)WARPS * KEYS * 2 * D + (size_t)KEYS * (2 * D + 4);
  return sizeof(float) * ((size_t)L * D * 2 + (size_t)L * (D + 4) * 2 + (size_t)L * 4 +
                          9 * D + (rows > keys ? rows : keys));
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
stripe_attention_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                                const float* __restrict__ lepe_w, float* __restrict__ dqkv,
                                float* __restrict__ dl_part, int H, int W, int C, int ch_off,
                                int cb, int h_sp, int w_sp, float scale) {
  static_assert(D % 8 == 0 && D <= 32, "head dims 16, 24, 32");
  constexpr int KS = D + 4;  // row stride of k and v
  constexpr int CH = D / 4;  // 16-byte chunks of a token's head slice
  constexpr int U = (QR * D + 31) / 32;  // dQ outputs a lane takes in a row group
  constexpr int FS = 2 * D + 4;          // row stride of the summed dK | dV rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = h_sp * w_sp, PS = p_stride_f32(L);
  float* Qs = reinterpret_cast<float*>(smem_raw);  // q·scale, L x D
  float* Os = Qs + L * D;                            // dO, L x D
  float* Ks = Os + L * D;                            // L x KS
  float* Vs = Ks + L * KS;
  float4* St = reinterpret_cast<float4*>(Vs + L * KS);  // max, sum, rowsum(dP∘P)
  float* Tw = reinterpret_cast<float*>(St + L);          // LePE taps, 9 x D
  float* Rg = Tw + 9 * D;                                // the phases' region

  const int n_wh = H / h_sp, n_ww = W / w_sp;
  const int win = blockIdx.x;
  const int b = win / (n_wh * n_ww);
  const int row0 = (win / n_ww) % n_wh * h_sp, col0 = win % n_ww * w_sp;
  const int head = blockIdx.y;
  const int hc = head * D;
  const int c0 = ch_off + hc;
  const size_t C3 = 3 * (size_t)C;
  const auto pixel = [&](int t) {
    return ((size_t)b * H + row0 + t / w_sp) * W + col0 + t % w_sp;
  };

  for (int i = threadIdx.x; i < L * CH; i += blockDim.x) {
    const int t = i / CH, c = i % CH * 4;
    const size_t m = pixel(t);
    const float* src = qkv + m * C3 + c0 + c;
    cp_async16(Ks + t * KS + c, src + C);
    cp_async16(Vs + t * KS + c, src + 2 * C);
    cp_async16(Os + t * D + c, dout + m * C + c0 + c);
    float4 q4 = __ldg(reinterpret_cast<const float4*>(src));
    q4.x *= scale;
    q4.y *= scale;
    q4.z *= scale;
    q4.w *= scale;
    *reinterpret_cast<float4*>(Qs + t * D + c) = q4;
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 9 * D; i += blockDim.x) Tw[i] = lepe_w[i / D * cb + hc + i % D];
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Rows: S, P, dP, dS of QR query rows, dQ, and the rows' statistics.
  {
    float* P = Rg + warp * QR * 2 * PS;  // S, then P
    float* G = P + QR * PS;              // dP, then dS
    for (int r0 = warp * QR; r0 < L; r0 += WARPS * QR) {
      const float* qr[QR];
      const float* orow[QR];
#pragma unroll
      for (int r = 0; r < QR; ++r) {  // a row past L repeats row L - 1, unstored
        qr[r] = Qs + min(r0 + r, L - 1) * D;
        orow[r] = Os + min(r0 + r, L - 1) * D;
      }
      float mx[QR], sum[QR], dl[QR];
#pragma unroll
      for (int r = 0; r < QR; ++r) mx[r] = -INFINITY;
      for (int j = lane; j < L; j += 32) {
        float sc[QR] = {}, dp[QR] = {};
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(Ks + j * KS + d);
          const float4 v4 = *reinterpret_cast<const float4*>(Vs + j * KS + d);
#pragma unroll
          for (int r = 0; r < QR; ++r) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr[r] + d);
            const float4 o4 = *reinterpret_cast<const float4*>(orow[r] + d);
            sc[r] = fmaf(q4.x, k4.x, sc[r]);
            sc[r] = fmaf(q4.y, k4.y, sc[r]);
            sc[r] = fmaf(q4.z, k4.z, sc[r]);
            sc[r] = fmaf(q4.w, k4.w, sc[r]);
            dp[r] = fmaf(o4.x, v4.x, dp[r]);
            dp[r] = fmaf(o4.y, v4.y, dp[r]);
            dp[r] = fmaf(o4.z, v4.z, dp[r]);
            dp[r] = fmaf(o4.w, v4.w, dp[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          P[r * PS + j] = sc[r];
          G[r * PS + j] = dp[r];
          mx[r] = fmaxf(mx[r], sc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        mx[r] = warp_max(mx[r]);
        sum[r] = 0.f;
        dl[r] = 0.f;
      }
      for (int j = lane; j < L; j += 32)
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const float e = expf(P[r * PS + j] - mx[r]);
          P[r * PS + j] = e;
          sum[r] += e;
        }
#pragma unroll
      for (int r = 0; r < QR; ++r) sum[r] = warp_sum(sum[r]);
      for (int j = lane; j < L; j += 32)
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          const float p = P[r * PS + j] / sum[r];
          P[r * PS + j] = p;
          dl[r] += G[r * PS + j] * p;
        }
#pragma unroll
      for (int r = 0; r < QR; ++r) dl[r] = warp_sum(dl[r]);
      // dS in place, and zeros past L up to PS (the 16-byte reads below).
      for (int j = lane; j < PS; j += 32)
#pragma unroll
        for (int r = 0; r < QR; ++r)
          G[r * PS + j] = j < L ? P[r * PS + j] * (G[r * PS + j] - dl[r]) : 0.f;
#pragma unroll
      for (int r = 0; r < QR; ++r)
        if (lane == r && r0 + r < L) St[r0 + r] = make_float4(mx[r], sum[r], dl[r], 0.f);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int o = lane + 32 * u, r = o / D, dd = o % D, i = r0 + r;
        if (o >= QR * D || i >= L) continue;
        const float* gr = G + r * PS;
        float acc = 0.f;
        for (int j = 0; j < L; j += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(gr + j);
          acc = fmaf(g4.x, Ks[j * KS + dd], acc);
          if (j + 1 < L) acc = fmaf(g4.y, Ks[(j + 1) * KS + dd], acc);
          if (j + 2 < L) acc = fmaf(g4.z, Ks[(j + 2) * KS + dd], acc);
          if (j + 3 < L) acc = fmaf(g4.w, Ks[(j + 3) * KS + dd], acc);
        }
        dqkv[pixel(i) * C3 + c0 + dd] = acc * scale;
      }
      __syncwarp();  // the group's rows are rewritten by the next
    }
  }
  __syncthreads();  // the statistics are complete; the region is the key phase's

  // Keys, KEYS at a time: lane l holds key j's k and v; warp w the rows
  // i ≡ w (mod WARPS).
  float* Red = Rg;                        // WARPS x 2D x KEYS partials
  float* Fin = Rg + WARPS * KEYS * 2 * D; // KEYS x FS summed rows
  for (int kb = 0; kb * KEYS < L; ++kb) {
    const int j = kb * KEYS + lane;
    const bool key = j < L;
    float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = key ? Ks[j * KS + d] : 0.f;
      vr[d] = key ? Vs[j * KS + d] : 0.f;
      dk[d] = dv[d] = 0.f;
    }
    for (int i = warp; i < L; i += WARPS) {
      const float4 st = St[i];
      const float* qi = Qs + i * D;
      const float* oi = Os + i * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qi + d);
        const float4 o4 = *reinterpret_cast<const float4*>(oi + d);
        s = fmaf(q4.x, kr[d], s);
        s = fmaf(q4.y, kr[d + 1], s);
        s = fmaf(q4.z, kr[d + 2], s);
        s = fmaf(q4.w, kr[d + 3], s);
        dp = fmaf(o4.x, vr[d], dp);
        dp = fmaf(o4.y, vr[d + 1], dp);
        dp = fmaf(o4.z, vr[d + 2], dp);
        dp = fmaf(o4.w, vr[d + 3], dp);
      }
      const float p = key ? expf(s - st.x) / st.y : 0.f;
      const float ds = p * (dp - st.z);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qi + d);
        const float4 o4 = *reinterpret_cast<const float4*>(oi + d);
        dk[d] = fmaf(ds, q4.x, dk[d]);
        dk[d + 1] = fmaf(ds, q4.y, dk[d + 1]);
        dk[d + 2] = fmaf(ds, q4.z, dk[d + 2]);
        dk[d + 3] = fmaf(ds, q4.w, dk[d + 3]);
        dv[d] = fmaf(p, o4.x, dv[d]);
        dv[d + 1] = fmaf(p, o4.y, dv[d + 1]);
        dv[d + 2] = fmaf(p, o4.z, dv[d + 2]);
        dv[d + 3] = fmaf(p, o4.w, dv[d + 3]);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      Red[(warp * 2 * D + d) * KEYS + lane] = dk[d];
      Red[(warp * 2 * D + D + d) * KEYS + lane] = dv[d];
    }
    __syncthreads();
    // The warps' partials in warp order; dV with the LePE transpose conv.
    for (int idx = threadIdx.x; idx < 2 * D * KEYS; idx += blockDim.x) {
      const int l = idx % KEYS, c2 = idx / KEYS, jj = kb * KEYS + l;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) v += Red[(q * 2 * D + c2) * KEYS + l];
      if (c2 >= D && jj < L) {
        const int dd = c2 - D, tr = jj / w_sp, tc = jj % w_sp;
        float lp = 0.f;
        for (int di = -1; di <= 1; ++di) {
          const int r = tr - di;
          if (r < 0 || r >= h_sp) continue;
          for (int dj = -1; dj <= 1; ++dj) {
            const int c = tc - dj;
            if (c < 0 || c >= w_sp) continue;
            lp = fmaf(Tw[((di + 1) * 3 + dj + 1) * D + dd], Os[(r * w_sp + c) * D + dd], lp);
          }
        }
        v += lp;
      }
      Fin[l * FS + c2] = v;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < KEYS * 2 * CH; idx += blockDim.x) {
      const int l = idx / (2 * CH), ch = idx % (2 * CH), jj = kb * KEYS + l;
      if (jj >= L) continue;
      const int third = ch < CH ? 1 : 2, c = (ch % CH) * 4;
      *reinterpret_cast<float4*>(dqkv + pixel(jj) * C3 + third * C + c0 + c) =
          *reinterpret_cast<const float4*>(Fin + l * FS + ch * 4);
    }
    __syncthreads();  // Red and Fin are rewritten by the next key block
  }

  // LePE weight (9 taps) and bias partials of this (window, head), as the
  // bf16 instance's: lane (channel pair, token group of 8), the groups added
  // by shuffles, (cb, 10) a window.
  {
    const int g = lane >> 2, q4 = lane & 3;
    const int cp = warp * 4 + q4, dd = 2 * cp;
    if (cp < D / 2) {
      float acc[10][2] = {};
      for (int t = g; t < L; t += 8) {
        const int tr = t / w_sp, tc = t % w_sp;
        const float2 o2 = *reinterpret_cast<const float2*>(Os + t * D + dd);
        acc[9][0] += o2.x;
        acc[9][1] += o2.y;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int r = tr + tap / 3 - 1, c = tc + tap % 3 - 1;
          if (r < 0 || r >= h_sp || c < 0 || c >= w_sp) continue;
          const float2 v2 = *reinterpret_cast<const float2*>(Vs + (r * w_sp + c) * KS + dd);
          acc[tap][0] = fmaf(o2.x, v2.x, acc[tap][0]);
          acc[tap][1] = fmaf(o2.y, v2.y, acc[tap][1]);
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

template <int D>
cudaError_t launch_f32(const float* qkv, const float* dout, const float* lw, float* dqkv,
                       float* dl, int B, int H, int W, int C, int ch_off, int cb, int heads,
                       int h_sp, int w_sp, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32<D>(h_sp * w_sp);
  cudaError_t err = allow_smem(stripe_attention_bwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (H / h_sp) * (W / w_sp), heads);
  stripe_attention_bwd_f32_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
      qkv, dout, lw, dqkv, dl, H, W, C, ch_off, cb, h_sp, w_sp, scale);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory the kernel takes for a window of L tokens at head
// dim D (16, 24 or 32; else 0): what kernels.stripe_attention_bwd_smem
// computes, for holding the two to one another on the card.
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
// multiples of 8 and qkv, dout, dqkv 16-byte aligned (16-byte copies);
// smem_bytes(L) at most 227 KB (checked by the wrapper).
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
  switch (cb / heads) {
    case 16: return (int)launch<16>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 24: return (int)launch<24>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 32: return (int)launch<32>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The float32 instance's shared memory (smem_bytes_f32), as
// cswin_stripe_attention_bwd_smem gives the bf16 one's.
CSWIN_API long long cswin_stripe_attention_bwd_f32_smem(int L, int D) {
  switch (D) {
    case 16: return (long long)smem_bytes_f32<16>(L);
    case 24: return (long long)smem_bytes_f32<24>(L);
    case 32: return (long long)smem_bytes_f32<32>(L);
    default: return 0;
  }
}

// The float32 instance: qkv, dout, dqkv float32, lepe_w (9, cb) float32,
// dl_part as above; C and ch_off multiples of 4 and qkv, dout, dqkv
// 16-byte aligned; smem_bytes_f32(L) at most 227 KB (checked by the
// wrapper).
CSWIN_API int cswin_stripe_attention_bwd_f32(const void* qkv, const void* dout,
                                             const void* lepe_w, void* dqkv, void* dl_part,
                                             int B, int H, int W, int C, int ch_off, int cb,
                                             int heads, int h_sp, int w_sp, float scale,
                                             void* stream) {
  const float* q = (const float*)qkv;
  const float* o = (const float*)dout;
  const float* lw = (const float*)lepe_w;
  float* g = (float*)dqkv;
  float* dl = (float*)dl_part;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cb / heads) {
    case 16: return (int)launch_f32<16>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 24: return (int)launch_f32<24>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    case 32: return (int)launch_f32<32>(q, o, lw, g, dl, B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
