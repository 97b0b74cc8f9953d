// Two consecutive dual-branch CSWin blocks of one stage in one launch
// (inference: no drop-path).
//
// Per block, the seven steps of the block chain (cswin_block.py):
//   LN1 -> qkv GEMM (+ bias) -> both stripe branches + LePE -> proj GEMM
//   (+ bias + residual) -> LN2 -> fc1 GEMM (+ bias, erf GELU) -> fc2 GEMM
//   (+ bias + residual)
// then the same seven for the second block on the first block's output:
// fourteen phases, each a grid-stride loop over that phase's tiles, with a
// grid-wide barrier between phases. Every tile is the device body the chain's
// own kernels run (layernorm_row.cuh, gemm_tile.cuh, attention_tile.cuh),
// with the same tile shapes and K order, so the result equals two chains bit
// for bit.
//
// Replaces: cswin_unet_tpu/ops/pallas/cswin_block.py::_fused_block_pair_fwd
//   (pallas_call :1957, body _block_pair_kernel_xt :1516): two blocks per
//   grid program with x1 kept in VMEM between them.
// Bound on the H100: the products, 2·M·12·C² tensor-core flops a block
//   (about 21 µs a pair at stage 3, B = 32, at 989 TFLOP/s), against one
//   read of x and the weights and one write of the output. Both this kernel
//   and the chain run far above that bound; what the pair removes is the
//   chain's 16 launches and wrapper calls a pair and the gaps between them.
// Design: one cooperative, persistent launch, grid = (CTAs per SM from the
//   occupancy API at this dynamic shared-memory size) x SMs, 128 threads
//   (the GEMM's four warps; the attention's four warps; four LayerNorm rows
//   per pass). The union of the phases takes the registers of the heaviest,
//   the GEMM loop (128, no spills: 4 CTAs per SM, where the chain's own
//   kernels run 5-8), so latency-bound phases have fewer warps to hide
//   behind than in the chain. Dynamic shared memory is the larger of the
//   GEMM tile's and the widest window's attention staging, reused by every
//   phase. cooperative_groups' grid sync separates the phases (the grid
//   workspace comes with the cooperative launch; no relocatable device
//   code). Intermediates go to scratch the wrapper allocates per call,
//   reused by the second block: at B = 32 they fit in the 50 MB L2, so x1
//   between the blocks need not reach HBM. A launch the card cannot make
//   co-resident fails and is returned.

#include <cooperative_groups.h>

#include "attention_tile.cuh"
#include "gemm_tile.cuh"
#include "layernorm_row.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
static_assert(gemm_tile::THREADS == THREADS && attn_tile::WARPS * 32 == THREADS,
              "the phases share one block shape");

// One block's parameters as the kernels read them: matrices, LePE taps
// (9, C/2) tap-major and LePE biases in bf16; LN and GEMM biases float32.
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

// a: (M, C) LN out / attention out; q: (M, 4C) qkv / fc1 out; x1: (M, C);
// mid: (M, C), the first block's output.
struct Scratch {
  bf16 *a, *q, *x1, *mid;
};

struct Geom {
  int B, H, W, C, heads, split;
  float scale, eps;
};

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

// Both stripe branches of one block: the vertical one (H x split windows,
// channels [0, C/2)) and then the horizontal one (split x W, [C/2, C)),
// heads/2 heads each, one (window, head) per tile.
template <int D>
__device__ __forceinline__ void attention_phase(const bf16* qkv, const BlockW& p,
                                                bf16* att, const Geom& g, float* smem) {
  const int C = g.C, half = C / 2, nh = g.heads / 2;
  const int tv = g.B * (g.W / g.split) * nh;
  const int tiles = tv + g.B * (g.H / g.split) * nh;
  const size_t ps = 3 * (size_t)C;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const bool vert = t < tv;
    const int u = vert ? t : t - tv;
    const int off = vert ? 0 : half;
    const bf16* q = qkv + off;
    attn_tile::tile<D, bf16, false>(q, q + C, q + 2 * C, ps, vert ? p.l0w : p.l1w,
                                    vert ? p.l0b : p.l1b, att + off, C, g.H, g.W, half,
                                    vert ? g.H : g.split, vert ? g.split : g.W, g.scale,
                                    u / nh, u % nh, smem);
    __syncthreads();
  }
}

// One block, x -> xout, in seven phases; the grid syncs between them.
template <int D>
__device__ __forceinline__ void block(cg::grid_group& grid, const bf16* x, const BlockW& p,
                                      const Scratch& s, bf16* xout, const Geom& g,
                                      unsigned char* smem) {
  auto& gs = *reinterpret_cast<gemm_tile::Smem*>(smem);
  const int M = g.B * g.H * g.W, C = g.C;
  ln_phase(x, p.n1w, p.n1b, s.a, M, C, g.eps);
  grid.sync();
  gemm_phase<0>(s.a, p.qkv_w, p.qkv_b, nullptr, s.q, M, 3 * C, C, gs);
  grid.sync();
  attention_phase<D>(s.q, p, s.a, g, reinterpret_cast<float*>(smem));
  grid.sync();
  gemm_phase<1>(s.a, p.proj_w, p.proj_b, x, s.x1, M, C, C, gs);
  grid.sync();
  ln_phase(s.x1, p.n2w, p.n2b, s.a, M, C, g.eps);
  grid.sync();
  gemm_phase<2>(s.a, p.fc1_w, p.fc1_b, nullptr, s.q, M, 4 * C, C, gs);
  grid.sync();
  gemm_phase<1>(s.q, p.fc2_w, p.fc2_b, s.x1, xout, M, C, 4 * C, gs);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
block_pair_kernel(const bf16* x, BlockW p1, BlockW p2, Scratch s, bf16* out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  block<D>(grid, x, p1, s, s.mid, g, smem);
  grid.sync();
  block<D>(grid, s.mid, p2, s, out, g, smem);
}

BlockW unpack(const void* const* v) {
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

template <int D>
int launch(const bf16* x, const void* const* params, bf16* scratch, bf16* out,
           const Geom& g, int* info, cudaStream_t stream) {
  const auto kernel = block_pair_kernel<D>;
  const int L = (g.H > g.W ? g.H : g.W) * g.split;
  size_t smem = attn_tile::smem_bytes<D>(L);
  if (smem < sizeof(gemm_tile::Smem)) smem = sizeof(gemm_tile::Smem);
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

  const size_t mc = (size_t)g.B * g.H * g.W * g.C;
  Scratch s{scratch, scratch + mc, scratch + 5 * mc, scratch + 6 * mc};
  BlockW p1 = unpack(params), p2 = unpack(params + 16);
  Geom geom = g;
  void* args[] = {(void*)&x, &p1, &p2, &s, (void*)&out, &geom};
  info[0] = per_sm * sms;
  info[1] = per_sm;
  info[2] = (int)smem;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), dim3(THREADS),
                                    args, smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x, out: (B, H, W, C) bf16, contiguous; params: a host array of 32 device
// pointers, each block's 16 in the order of BlockW (the wrapper's cast
// weights); scratch: 7·B·H·W·C bf16. Requires a dual-branch geometry
// (split < H, H % split == W % split == 0), C % 8 == 0, heads even and
// head_dim = C / heads of 16, 24 or 32. info (host, 3 ints) receives the
// grid, the CTAs per SM and the dynamic shared memory in bytes.
CSWIN_API int cswin_block_pair(const void* x, const void* const* params, void* scratch,
                               void* out, int B, int H, int W, int C, int heads,
                               int split, float scale, float eps, int* info,
                               void* stream) {
  if (split >= H || H % split || W % split || C % 8 || heads % 2 || C % heads)
    return (int)cudaErrorInvalidValue;
  const Geom g{B, H, W, C, heads, split, scale, eps};
  const bf16* xb = (const bf16*)x;
  bf16* sb = (bf16*)scratch;
  bf16* ob = (bf16*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C / heads) {
    case 16: return launch<16>(xb, params, sb, ob, g, info, s);
    case 24: return launch<24>(xb, params, sb, ob, g, info, s);
    case 32: return launch<32>(xb, params, sb, ob, g, info, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
