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
// The activations' type T is bf16, or float for TPU.COMPUTE_DTYPE float32
// (block_pair.cu's float32 instance): the float phases run the float32
// tiles (layernorm_row.cuh at T = float, gemm_f32_tile.cuh,
// attn_tile::tile_f32), which the chain's float32 kernels run too.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "gemm_f32_tile.cuh"
#include "gemm_tile.cuh"
#include "layernorm_row.cuh"

namespace block_phases {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
static_assert(gemm_tile::THREADS == THREADS && attn_tile::WARPS * 32 == THREADS,
              "the phases share one block shape");
// CTAs an SM block_one.cu is built for (__launch_bounds__): 4 leaves 128
// registers a thread. block_pair.cu, with two blocks' state, takes more.
constexpr int MIN_CTAS = 4;
// n8 key tiles of scores the attention phase holds in registers: 64 keys
// (the one-tile kernels hold 112), so that it fits beside the kernels'
// other state. The result does not depend on it.
constexpr int ATTN_KT = 8;
// The widest rows the float32 phases take: LN_ROW_INSTANCE_F32's instances
// up to 4 vectors of 4 floats a lane (ln_phase).
constexpr int F32_MAX_C = 512;
// The float32 GEMM phases' shared memory: gemm_f32.cu's 64 x 64 tile.
using GemmF32Smem = gemm_f32::Smem<64, 64, false>;
static_assert(gemm_f32::Shape<64, 64, false>::THREADS == THREADS, "the float32 tile's threads");

// One block's parameters as the kernels read them: matrices, LePE taps
// (9, cb) tap-major and LePE biases in the activations' type T; LN and GEMM
// biases float32.
template <typename T>
struct BlockWT {
  const float *n1w, *n1b;
  const T* qkv_w;
  const float* qkv_b;  // may be null
  const T *l0w, *l0b, *l1w, *l1b;
  const T* proj_w;
  const float* proj_b;
  const float *n2w, *n2b;
  const T* fc1_w;
  const float* fc1_b;
  const T* fc2_w;
  const float* fc2_b;
};
using BlockW = BlockWT<bf16>;

// a: (M, C) LN1 out, then the attention out; q: (M, 3C) qkv; h: (M, 4C) the
// fc1 out (the pair: h == q); x1: (M, C); y: (M, C) the LN2 out (the pair:
// y == a); mid: (M, C), the pair's first block's output.
template <typename T>
struct ScratchT {
  T *a, *q, *h, *x1, *y, *mid;
};
using Scratch = ScratchT<bf16>;

struct Geom {
  int B, H, W, C, heads, split;
  float scale, eps;
};

// One stripe branch: its channels [off, off + cb) of each third of qkv, nh
// heads, windows h_sp x w_sp, its LePE.
template <typename T>
struct BranchT {
  int off, cb, nh, h_sp, w_sp;
  const T *lw, *lb;
};
using Branch = BranchT<bf16>;

// Phases a block runs: LN on or off (the GEMMs then read x and x1 as they
// are), GELU on or off (fc1 takes the bias-only epilogue), one or two
// branches, and the last phase run: STOP_QKV, STOP_ATTENTION, STOP_PROJ or
// STOP_ALL.
enum Stop { STOP_NONE = 0, STOP_QKV = 2, STOP_ATTENTION = 3, STOP_PROJ = 4, STOP_ALL = 7 };

template <typename T>
struct PlanT {
  int ln, gelu, branches, stop;
  BranchT<T> b0, b1;
};
using Plan = PlanT<bf16>;

// The dual-branch plan with every part on: the vertical branch (H x split
// windows, channels [0, C/2)), then the horizontal one (split x W, [C/2, C)),
// heads/2 heads each.
template <typename T>
inline PlanT<T> full_dual_plan(const BlockWT<T>& p, const Geom& g) {
  const int half = g.C / 2, nh = g.heads / 2;
  PlanT<T> plan{1, 1, 2, STOP_ALL, {}, {}};
  plan.b0 = BranchT<T>{0, half, nh, g.H, g.split, p.l0w, p.l0b};
  plan.b1 = BranchT<T>{half, half, nh, g.split, g.W, p.l1w, p.l1b};
  return plan;
}

// LN over the phase's rows on layernorm_row.cuh's body, THREADS / G rows a
// CTA step, the grid striding over the steps: the same bits as the one-launch
// layernorm_kernel. γ and β are read where used, not held: the GEMM and
// attention phases set the kernel's registers. The entry points refuse a C
// it does not take.
template <typename T>
__device__ __forceinline__ void ln_phase(const T* x, const float* w, const float* b, T* y,
                                         int rows, int C, float eps) {
  if constexpr (std::is_same_v<T, float>) {
    // The float32 pair's widths (C <= F32_MAX_C): the chain's instances for
    // them; the instances of wider rows would hold the whole kernel at their
    // registers (8 vectors of 4 floats a lane, double-buffered).
#define BLOCK_PHASES_LN_ROWS(G, V) \
  ln_row::rows<G, V, false>(x, C, w, b, y, C, rows, C, eps, THREADS, blockIdx.x, gridDim.x)
    C <= 16 ? BLOCK_PHASES_LN_ROWS(4, 1) : C <= 32 ? BLOCK_PHASES_LN_ROWS(8, 1)
    : C <= 64 ? BLOCK_PHASES_LN_ROWS(16, 1) : C <= 128 ? BLOCK_PHASES_LN_ROWS(32, 1)
    : C <= 256 ? BLOCK_PHASES_LN_ROWS(32, 2) : C <= 384 ? BLOCK_PHASES_LN_ROWS(32, 3)
    : BLOCK_PHASES_LN_ROWS(32, 4);
#undef BLOCK_PHASES_LN_ROWS
  } else {
    ln_row::rows_any<false>(x, C, w, b, y, C, rows, C, eps, THREADS, blockIdx.x, gridDim.x);
  }
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

// The float32 GEMM phase on the chain's float32 tile (gemm_f32_tile.cuh),
// 64 x 64 outputs a CTA: the chain's planner picks 128 x 32 where N's
// 32-column tiles waste fewer columns, and either gives the same bits.
template <int EPI>
__device__ __forceinline__ void gemm_phase(const float* A, const float* Bw,
                                           const float* bias, const float* res,
                                           float* out, int M, int N, int K, GemmF32Smem& sm) {
  constexpr int BM = 64, BN = 64;
  const int tn = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    gemm_f32::tile<BM, BN, false, EPI, false, false, false>(
        A, Bw, bias, res, nullptr, nullptr, nullptr, out, M, N, K, 1, t / tn * BM,
        t % tn * BN, DropArgs(), sm);
    __syncthreads();  // the next tile restages the shared memory
  }
}

// The plan's branches, one (window, head) per tile: b0's tiles, then b1's.
template <int D, int MODE, typename T>
__device__ __forceinline__ void attention_phase(const T* qkv, const PlanT<T>& plan, T* att,
                                                const Geom& g, float* smem) {
  const int C = g.C;
  const BranchT<T> &b0 = plan.b0, &b1 = plan.b1;
  const int t0 = g.B * (g.H / b0.h_sp) * (g.W / b0.w_sp) * b0.nh;
  const int tiles =
      t0 + (plan.branches > 1 ? g.B * (g.H / b1.h_sp) * (g.W / b1.w_sp) * b1.nh : 0);
  const size_t ps = 3 * (size_t)C;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const bool first = t < t0;
    const int u = first ? t : t - t0;
    const int off = first ? b0.off : b1.off, nh = first ? b0.nh : b1.nh;
    const T* q = qkv + off;
    if constexpr (std::is_same_v<T, float>)
      attn_tile::tile_f32<D>(q, q + C, q + 2 * C, ps, first ? b0.lw : b1.lw,
                             first ? b0.lb : b1.lb, att + off, C, g.H, g.W,
                             first ? b0.cb : b1.cb, first ? b0.h_sp : b1.h_sp,
                             first ? b0.w_sp : b1.w_sp, g.scale, u / nh, u % nh, smem);
    else
      attn_tile::tile<D, bf16, false, MODE, ATTN_KT>(
          q, q + C, q + 2 * C, ps, first ? b0.lw : b1.lw, first ? b0.lb : b1.lb, att + off, C,
          g.H, g.W, first ? b0.cb : b1.cb, first ? b0.h_sp : b1.h_sp,
          first ? b0.w_sp : b1.w_sp, g.scale, u / nh, u % nh, smem);
    __syncthreads();
  }
}

// One block, x -> xout, in the plan's phases; the grid syncs between them.
// A plan that stops early leaves its last phase's output in the scratch and
// returns without a final sync.
template <int D, int MODE, typename T>
__device__ __forceinline__ void block(cg::grid_group& grid, const T* x, const BlockWT<T>& p,
                                      const ScratchT<T>& s, T* xout, const Geom& g,
                                      const PlanT<T>& plan, unsigned char* smem) {
  static_assert(std::is_same_v<T, float> ? MODE == attn_tile::FULL : true,
                "the float32 phases run the full block");
  using GemmSmem = std::conditional_t<std::is_same_v<T, float>, GemmF32Smem, gemm_tile::Smem>;
  auto& gs = *reinterpret_cast<GemmSmem*>(smem);
  const int M = g.B * g.H * g.W, C = g.C;
  if (plan.stop < STOP_QKV) return;
  const T* xn = x;
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
  const T* yn = s.x1;
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
template <typename T = bf16>
inline BlockWT<T> unpack(const void* const* v) {
  BlockWT<T> p;
  p.n1w = (const float*)v[0];
  p.n1b = (const float*)v[1];
  p.qkv_w = (const T*)v[2];
  p.qkv_b = (const float*)v[3];
  p.l0w = (const T*)v[4];
  p.l0b = (const T*)v[5];
  p.l1w = (const T*)v[6];
  p.l1b = (const T*)v[7];
  p.proj_w = (const T*)v[8];
  p.proj_b = (const float*)v[9];
  p.n2w = (const float*)v[10];
  p.n2b = (const float*)v[11];
  p.fc1_w = (const T*)v[12];
  p.fc1_b = (const float*)v[13];
  p.fc2_w = (const T*)v[14];
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
// widest window's attention staging, at the activations' type T.
template <int D, typename T = bf16>
size_t smem_bytes(int L) {
  if constexpr (std::is_same_v<T, float>) {
    const size_t a = attn_tile::smem_bytes_f32<D>(L);
    return a < sizeof(GemmF32Smem) ? sizeof(GemmF32Smem) : a;
  } else {
    const size_t a = attn_tile::smem_bytes<D>(L);
    return a < sizeof(gemm_tile::Smem) ? sizeof(gemm_tile::Smem) : a;
  }
}

}  // namespace block_phases
