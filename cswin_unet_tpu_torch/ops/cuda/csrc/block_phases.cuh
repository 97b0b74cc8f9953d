// One CSWin block in seven phases for a cooperative, persistent launch, as
// device functions shared by the two whole-block kernels (block_pair.cu,
// block_one.cu).
//
// The phases are the block chain's steps (cswin_block.py):
//   LN1 -> qkv GEMM (+ bias) -> the stripe branches + LePE -> proj GEMM
//   (+ bias + residual) -> LN2 -> fc1 GEMM (+ bias, erf GELU) -> fc2 GEMM
//   (+ bias + residual)
// each a grid-stride loop over that phase's tiles, with a grid-wide barrier
// between phases. Every tile is the device body the chain's own kernels run
// (layernorm_row.cuh, gemm_tile.cuh, attention_tile.cuh), with the same
// tile shapes and K order, so a block run here with every part on equals the
// chain bit for bit. A Plan switches parts off or stops early (the block
// lab's ablation and build-up, block_one.cu); the pair runs every part.
#pragma once

#include <cooperative_groups.h>

#include "attention_tile.cuh"
#include "gemm_tile.cuh"
#include "layernorm_row.cuh"

namespace block_phases {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
static_assert(gemm_tile::THREADS == THREADS && attn_tile::WARPS * 32 == THREADS,
              "the phases share one block shape");

// One block's parameters as the kernels read them: matrices, LePE taps
// (9, cb) tap-major and LePE biases in bf16; LN and GEMM biases float32.
struct BlockW {
  const float *n1w, *n1b;
  const bf16* qkv_w;
  const float* qkv_b;  // may be null
  const bf16 *l0w, *l0b, *l1w, *l1b;
  const bf16* proj_w;
  const float* proj_b;
  const float *n2w, *n2b;
  const bf16* fc1_w;
  const float* fc1_b;
  const bf16* fc2_w;
  const float* fc2_b;
};

// a: (M, C) LN1 out, then the attention out; q: (M, 3C) qkv; h: (M, 4C) the
// fc1 out (the pair: h == q); x1: (M, C); y: (M, C) the LN2 out (the pair:
// y == a); mid: (M, C), the pair's first block's output.
struct Scratch {
  bf16 *a, *q, *h, *x1, *y, *mid;
};

struct Geom {
  int B, H, W, C, heads, split;
  float scale, eps;
};

// One stripe branch: its channels [off, off + cb) of each third of qkv, nh
// heads, windows h_sp x w_sp, its LePE.
struct Branch {
  int off, cb, nh, h_sp, w_sp;
  const bf16 *lw, *lb;
};

// Phases a block runs: LN on or off (the GEMMs then read x and x1 as they
// are), GELU on or off (fc1 takes the bias-only epilogue), one or two
// branches, and the last phase run: STOP_QKV, STOP_ATTENTION, STOP_PROJ or
// STOP_ALL.
enum Stop { STOP_NONE = 0, STOP_QKV = 2, STOP_ATTENTION = 3, STOP_PROJ = 4, STOP_ALL = 7 };

struct Plan {
  int ln, gelu, branches, stop;
  Branch b0, b1;
};

// The dual-branch plan with every part on: the vertical branch (H x split
// windows, channels [0, C/2)), then the horizontal one (split x W, [C/2, C)),
// heads/2 heads each.
inline Plan full_dual_plan(const BlockW& p, const Geom& g) {
  const int half = g.C / 2, nh = g.heads / 2;
  Plan plan{1, 1, 2, STOP_ALL, {}, {}};
  plan.b0 = Branch{0, half, nh, g.H, g.split, p.l0w, p.l0b};
  plan.b1 = Branch{half, half, nh, g.split, g.W, p.l1w, p.l1b};
  return plan;
}

__device__ __forceinline__ void ln_phase(const bf16* x, const float* w, const float* b,
                                         bf16* y, int rows, int C, float eps) {
  constexpr int ROWS = THREADS / 32;
  for (int r = blockIdx.x * ROWS + (threadIdx.x >> 5); r < rows; r += gridDim.x * ROWS)
    ln_row::row(x, w, b, y, r, C, eps, threadIdx.x & 31);
}

template <int EPI>
__device__ __forceinline__ void gemm_phase(const bf16* A, const bf16* Bw,
                                           const float* bias, const bf16* res,
                                           bf16* out, int M, int N, int K,
                                           gemm_tile::Smem& sm) {
  const int tn = (N + gemm_tile::BN - 1) / gemm_tile::BN;
  const int tiles = (M + gemm_tile::BM - 1) / gemm_tile::BM * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    gemm_tile::tile<EPI, false, false>(A, Bw, bias, res, nullptr, nullptr, nullptr, out,
                                       M, N, K, 1, t / tn * gemm_tile::BM,
                                       t % tn * gemm_tile::BN, sm);
    __syncthreads();  // the next tile restages the shared memory
  }
}

// The plan's branches, one (window, head) per tile: b0's tiles, then b1's.
template <int D, int MODE>
__device__ __forceinline__ void attention_phase(const bf16* qkv, const Plan& plan,
                                                bf16* att, const Geom& g, float* smem) {
  const int C = g.C;
  const Branch &b0 = plan.b0, &b1 = plan.b1;
  const int t0 = g.B * (g.H / b0.h_sp) * (g.W / b0.w_sp) * b0.nh;
  const int tiles =
      t0 + (plan.branches > 1 ? g.B * (g.H / b1.h_sp) * (g.W / b1.w_sp) * b1.nh : 0);
  const size_t ps = 3 * (size_t)C;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const bool first = t < t0;
    const int u = first ? t : t - t0;
    const int off = first ? b0.off : b1.off, nh = first ? b0.nh : b1.nh;
    const bf16* q = qkv + off;
    attn_tile::tile<D, bf16, false, MODE>(
        q, q + C, q + 2 * C, ps, first ? b0.lw : b1.lw, first ? b0.lb : b1.lb, att + off, C,
        g.H, g.W, first ? b0.cb : b1.cb, first ? b0.h_sp : b1.h_sp,
        first ? b0.w_sp : b1.w_sp, g.scale, u / nh, u % nh, smem);
    __syncthreads();
  }
}

// One block, x -> xout, in the plan's phases; the grid syncs between them.
// A plan that stops early leaves its last phase's output in the scratch and
// returns without a final sync.
template <int D, int MODE>
__device__ __forceinline__ void block(cg::grid_group& grid, const bf16* x, const BlockW& p,
                                      const Scratch& s, bf16* xout, const Geom& g,
                                      const Plan& plan, unsigned char* smem) {
  auto& gs = *reinterpret_cast<gemm_tile::Smem*>(smem);
  const int M = g.B * g.H * g.W, C = g.C;
  if (plan.stop < STOP_QKV) return;
  const bf16* xn = x;
  if (plan.ln) {
    ln_phase(x, p.n1w, p.n1b, s.a, M, C, g.eps);
    grid.sync();
    xn = s.a;
  }
  gemm_phase<0>(xn, p.qkv_w, p.qkv_b, nullptr, s.q, M, 3 * C, C, gs);
  if (plan.stop < STOP_ATTENTION) return;
  grid.sync();
  attention_phase<D, MODE>(s.q, plan, s.a, g, reinterpret_cast<float*>(smem));
  if (plan.stop < STOP_PROJ) return;
  grid.sync();
  gemm_phase<1>(s.a, p.proj_w, p.proj_b, x, s.x1, M, C, C, gs);
  if (plan.stop < STOP_ALL) return;
  grid.sync();
  const bf16* yn = s.x1;
  if (plan.ln) {
    ln_phase(s.x1, p.n2w, p.n2b, s.y, M, C, g.eps);
    grid.sync();
    yn = s.y;
  }
  if (plan.gelu)
    gemm_phase<2>(yn, p.fc1_w, p.fc1_b, nullptr, s.h, M, 4 * C, C, gs);
  else
    gemm_phase<0>(yn, p.fc1_w, p.fc1_b, nullptr, s.h, M, 4 * C, C, gs);
  grid.sync();
  gemm_phase<1>(s.h, p.fc2_w, p.fc2_b, s.x1, xout, M, C, 4 * C, gs);
}

// A host array of 16 device pointers in the order of BlockW.
inline BlockW unpack(const void* const* v) {
  BlockW p;
  p.n1w = (const float*)v[0];
  p.n1b = (const float*)v[1];
  p.qkv_w = (const bf16*)v[2];
  p.qkv_b = (const float*)v[3];
  p.l0w = (const bf16*)v[4];
  p.l0b = (const bf16*)v[5];
  p.l1w = (const bf16*)v[6];
  p.l1b = (const bf16*)v[7];
  p.proj_w = (const bf16*)v[8];
  p.proj_b = (const float*)v[9];
  p.n2w = (const float*)v[10];
  p.n2b = (const float*)v[11];
  p.fc1_w = (const bf16*)v[12];
  p.fc1_b = (const float*)v[13];
  p.fc2_w = (const bf16*)v[14];
  p.fc2_b = (const float*)v[15];
  return p;
}

// Launch `kernel` cooperatively, as many CTAs as fit on the card at once
// (the occupancy API at this dynamic shared memory, THREADS threads): a
// launch the card cannot make co-resident fails and is returned. info
// (host, 3 ints) receives the grid, the CTAs per SM and the dynamic shared
// memory in bytes.
template <typename Kernel>
int launch_cooperative(Kernel kernel, size_t smem, void** args, int* info,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                           smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  info[0] = per_sm * sms;
  info[1] = per_sm;
  info[2] = (int)smem;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), dim3(THREADS),
                                    args, smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Dynamic shared memory of the phases: the larger of the GEMM tile's and the
// widest window's attention staging.
template <int D>
size_t smem_bytes(int L) {
  const size_t a = attn_tile::smem_bytes<D>(L);
  return a < sizeof(gemm_tile::Smem) ? sizeof(gemm_tile::Smem) : a;
}

}  // namespace block_phases
