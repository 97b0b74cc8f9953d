// Two consecutive dual-branch CSWin blocks of one stage in one launch
// (inference: no drop-path).
//
// Per block, the seven steps of the block chain in the phases of
// block_phases.cuh (LN1, qkv, both stripe branches + LePE, proj + residual,
// LN2, fc1 + GELU, fc2 + residual), then the same seven for the second block
// on the first block's output: fourteen phases with a grid-wide barrier
// between them. Every tile is the device body the chain's own kernels run,
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

#include "block_phases.cuh"

namespace {

using namespace block_phases;

template <int D>
__global__ void __launch_bounds__(THREADS)
block_pair_kernel(const bf16* x, BlockW p1, BlockW p2, Plan plan1, Plan plan2, Scratch s,
                  bf16* out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  block<D, attn_tile::FULL>(grid, x, p1, s, s.mid, g, plan1, smem);
  grid.sync();
  block<D, attn_tile::FULL>(grid, s.mid, p2, s, out, g, plan2, smem);
}

template <int D>
int launch(const bf16* x, const void* const* params, bf16* scratch, bf16* out,
           const Geom& g, int* info, cudaStream_t stream) {
  const size_t mc = (size_t)g.B * g.H * g.W * g.C;
  Scratch s{scratch, scratch + mc, scratch + mc, scratch + 5 * mc, scratch, scratch + 6 * mc};
  BlockW p1 = unpack(params), p2 = unpack(params + 16);
  Plan plan1 = full_dual_plan(p1, g), plan2 = full_dual_plan(p2, g);
  Geom geom = g;
  void* args[] = {(void*)&x, &p1, &p2, &plan1, &plan2, &s, (void*)&out, &geom};
  const int L = (g.H > g.W ? g.H : g.W) * g.split;
  return launch_cooperative(block_pair_kernel<D>, block_phases::smem_bytes<D>(L), args, info,
                            stream);
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
