// One CSWin block of one stage in one launch, with parts switched off or the
// block built up phase by phase (the block lab's `ablate` and `cum`).
//
// The seven phases of block_phases.cuh (LN1, qkv, the stripe branches +
// LePE, proj + residual, LN2, fc1 + GELU, fc2 + residual) under a plan:
//   * LN off: the qkv and fc1 GEMMs read x and x1 as they are;
//   * GELU off: fc1 takes the bias-only epilogue;
//   * transpose off: the vertical branch is windowed as the horizontal one
//     (split x W windows and its LePE over them), a different function;
//   * the attention form, a compile-time mode of the tile
//     (attention_tile.cuh): P = softmax(s) (FULL, NO_LEPE), P = bf16(s/L)
//     (SCALE, SCALE_NO_LEPE), each with LePE or without, or no attention,
//     out = v + LePE (VALUE);
//   * the last stage: one branch, all heads, over the full H x W window with
//     the first LePE;
//   * a build-up level (0-7, square dual-branch stages): the phases it needs,
//     then an epilogue that sums its terms into one float32 accumulator and
//     writes bf16(acc) (cum_phase below).
// With every part on, the tiles and their K order are the chain's, so the
// output equals one block chain bit for bit.
//
// Replaces: scripts/ablate_block.py::build.<apply> (pallas_call :181, body
//   _kernel :110 with _branch :44): the whole block of one image per grid
//   program with one part switched off; and scripts/exp_cum.py::main.<fn>
//   (pallas_call :137, body make_level_kernel.kern :39): the stage-1 block
//   built up in eight levels, each level's values folded into one float32
//   accumulator.
// Bound on the H100: the block's products (2·M·12·C²) and the attention's
//   (4·L·c a token a branch), bf16 operands at the tensor cores' 989
//   TFLOP/s, beside the LN / softmax / GELU / LePE arithmetic at float32's
//   67 TFLOP/s, against one read of x and the weights and one write of the
//   output.
// Design: block_pair.cu's cooperative, persistent launch for one block:
//   grid = (CTAs per SM from the occupancy API) x SMs, 128 threads, dynamic
//   shared memory the larger of the GEMM tile's and the widest window's
//   attention staging; the fc1 and LN2 outputs get their own scratch so
//   that the build-up epilogue can still read qkv and the attention output
//   at the last level.

#include "block_phases.cuh"

namespace {

using namespace block_phases;

enum Flags { LN = 1, GELU = 2, TRANSPOSE = 4, V_ONLY = 8 };

// bf16((q + k) + v), rounded after each add: the script's fold of one
// half's q, k and v groups.
__device__ __forceinline__ float fold3(const bf16* p, int C) {
  return round_bf16(round_bf16(bf2f(p[0]) + bf2f(p[C])) + bf2f(p[2 * C]));
}

// The build-up's accumulator at `level`, element by element (square images:
// T moves pixel (h, w) to (w, h); D(z) puts z in both channel halves):
//   acc = x + 1e-6·T(x)
//       + D(F(qkv_h))          level >= 1   (F: fold3 of the horizontal half)
//       + T(D(F(qkv_v)))       level >= 2
//       + T(D(a0))             level 3      (a0 without LePE)
//       + D(a0)                levels 4, 5  (a0 with LePE)
//       + D(a1)                level >= 5
//       + x1                   level >= 6
//       + out                  level 7      (the block's output)
// and out = bf16(acc). Adds and the product round as written (no fused
// multiply-add), in this order.
__device__ __forceinline__ void cum_phase(const bf16* __restrict__ x, const Scratch& s,
                                          bf16* out, const Geom& g, int level) {
  const int C = g.C, half = C / 2;
  const size_t n = (size_t)g.B * g.H * g.W * C;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    const int c = (int)(i % C), j = c % half;
    const size_t pix = i / C;
    const int w = (int)(pix % g.W), h = (int)(pix / g.W % g.H);
    const size_t tp = (pix / ((size_t)g.W * g.H) * g.H + w) * g.W + h;
    float acc = __fadd_rn(bf2f(x[i]), __fmul_rn(bf2f(x[tp * C + c]), 1e-6f));
    if (level >= 1) acc = __fadd_rn(acc, fold3(s.q + pix * 3 * C + half + j, C));
    if (level >= 2) acc = __fadd_rn(acc, fold3(s.q + tp * 3 * C + j, C));
    if (level == 3) acc = __fadd_rn(acc, bf2f(s.a[tp * C + j]));
    if (level == 4 || level == 5) acc = __fadd_rn(acc, bf2f(s.a[pix * C + j]));
    if (level >= 5) acc = __fadd_rn(acc, bf2f(s.a[pix * C + half + j]));
    if (level >= 6) acc = __fadd_rn(acc, bf2f(s.x1[i]));
    if (level == 7) acc = __fadd_rn(acc, bf2f(out[i]));
    out[i] = f2bf(acc);
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
block_one_kernel(const bf16* x, BlockW p, Scratch s, bf16* out, Geom g, Plan plan,
                 int level) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  block<D, MODE>(grid, x, p, s, out, g, plan, smem);
  if (level < 0) return;
  if (plan.stop > STOP_NONE) grid.sync();
  cum_phase(x, s, out, g, level);
}

template <int MODE>
int launch(const bf16* x, const BlockW& p, const Plan& plan, bf16* scratch, bf16* out,
           const Geom& g, int level, int* info, cudaStream_t stream) {
  constexpr int D = 32;
  const size_t mc = (size_t)g.B * g.H * g.W * g.C;
  Scratch s{scratch, scratch + mc, scratch + 5 * mc, scratch + 4 * mc, scratch + 9 * mc,
            nullptr};
  BlockW pw = p;
  Plan pl = plan;
  Geom geom = g;
  void* args[] = {(void*)&x, &pw, &s, (void*)&out, &geom, &pl, &level};
  int L = plan.b0.h_sp * plan.b0.w_sp;
  if (plan.branches > 1 && plan.b1.h_sp * plan.b1.w_sp > L) L = plan.b1.h_sp * plan.b1.w_sp;
  return launch_cooperative(block_one_kernel<D, MODE>, block_phases::smem_bytes<D>(L), args,
                            info, stream);
}

}  // namespace

// x, out: (B, H, W, C) bf16, contiguous; params: a host array of 16 device
// pointers in the order of BlockW (a last-stage block passes its one LePE in
// both slots); scratch: 10·B·H·W·C bf16. mode: the attention form
// (attention_tile.cuh: FULL, NO_LEPE, SCALE, SCALE_NO_LEPE, VALUE); flags:
// LN | GELU | TRANSPOSE | V_ONLY (the vertical branch alone); stop: the last
// phase run (block_phases::Stop); level: -1 for the block's output, 0-7 for
// the build-up epilogue (dual-branch, H == W). A last stage is split >= H.
// Head dim C / heads must be 32 (tiny-224), C % 8 == 0 and C <= 1024
// (ln_row::supported).
// info (host, 3 ints) receives the grid, the CTAs per SM and the dynamic
// shared memory in bytes.
CSWIN_API int cswin_block_one(const void* x, const void* const* params, void* scratch,
                              void* out, int B, int H, int W, int C, int heads, int split,
                              float scale, float eps, int mode, int flags, int stop,
                              int level, int* info, void* stream) {
  const bool last = split >= H;
  if (!ln_row::supported(C) || C % heads || C / heads != 32 ||
      (!last && (heads % 2 || H % split || W % split)))
    return (int)cudaErrorInvalidValue;
  if (level > 7 || (level >= 0 && (last || H != W)) ||
      (stop != STOP_NONE && stop != STOP_QKV && stop != STOP_ATTENTION &&
       stop != STOP_PROJ && stop != STOP_ALL))
    return (int)cudaErrorInvalidValue;
  const Geom g{B, H, W, C, heads, split, scale, eps};
  const BlockW p = unpack(params);
  Plan plan{(flags & LN) != 0, (flags & GELU) != 0, 1, stop, {}, {}};
  if (last) {
    plan.b0 = Branch{0, C, heads, H, W, p.l0w, p.l0b};
  } else {
    const int half = C / 2, nh = heads / 2;
    plan.b0 = (flags & TRANSPOSE) ? Branch{0, half, nh, H, split, p.l0w, p.l0b}
                                  : Branch{0, half, nh, split, W, p.l0w, p.l0b};
    plan.b1 = Branch{half, half, nh, split, W, p.l1w, p.l1b};
    plan.branches = (flags & V_ONLY) ? 1 : 2;
  }
  const bf16* xb = (const bf16*)x;
  bf16* sb = (bf16*)scratch;
  bf16* ob = (bf16*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case attn_tile::FULL: return launch<attn_tile::FULL>(xb, p, plan, sb, ob, g, level, info, s);
    case attn_tile::NO_LEPE: return launch<attn_tile::NO_LEPE>(xb, p, plan, sb, ob, g, level, info, s);
    case attn_tile::SCALE: return launch<attn_tile::SCALE>(xb, p, plan, sb, ob, g, level, info, s);
    case attn_tile::SCALE_NO_LEPE: return launch<attn_tile::SCALE_NO_LEPE>(xb, p, plan, sb, ob, g, level, info, s);
    case attn_tile::VALUE: return launch<attn_tile::VALUE>(xb, p, plan, sb, ob, g, level, info, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
