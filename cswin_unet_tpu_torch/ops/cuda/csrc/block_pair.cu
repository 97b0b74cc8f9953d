// Two consecutive dual-branch CSWin blocks of one stage in one launch
// (inference: no drop-path), in bf16 (cswin_block_pair) or, for
// TPU.COMPUTE_DTYPE float32, on the float32 tiles (cswin_block_pair_f32).
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
//   the attention phase beside the two blocks' state: held to 128 (4 CTAs
//   an SM, block_one's bound) it spills a few bytes, so the bf16 pair takes
//   what ptxas gives it and runs the CTAs an SM the occupancy API allows for
//   that (chip_smoke.py prints the grid), where the chain's own kernels run
//   4-8; the float32 pair is held to block_pair.cuh's F32_CTAS.
//   Latency-bound phases have fewer warps to hide behind than in the chain. Dynamic shared memory is the larger of the
//   GEMM tile's and the widest window's attention staging, reused by every
//   phase. cooperative_groups' grid sync separates the phases (the grid
//   workspace comes with the cooperative launch; no relocatable device
//   code). Intermediates go to scratch the wrapper allocates per call,
//   reused by the second block: at B = 32 they fit in the 50 MB L2, so x1
//   between the blocks need not reach HBM. A launch the card cannot make
//   co-resident fails and is returned.

#include "block_pair.cuh"

// x, out: (B, H, W, C) bf16, contiguous; params: a host array of 32 device
// pointers, each block's 16 in the order of BlockW (the wrapper's cast
// weights); scratch: 7·B·H·W·C bf16. Requires a dual-branch geometry
// (split < H, H % split == W % split == 0), C % 8 == 0 and C <= 1024 (the
// LN phases' rows, ln_row::supported), heads even and
// head_dim = C / heads of 16, 24 or 32. info (host, 3 ints) receives the
// grid, the CTAs per SM and the dynamic shared memory in bytes.
CSWIN_API int cswin_block_pair(const void* x, const void* const* params, void* scratch,
                               void* out, int B, int H, int W, int C, int heads,
                               int split, float scale, float eps, int* info,
                               void* stream) {
  return dispatch<bf16>(x, params, scratch, out, B, H, W, C, heads, split, scale, eps,
                        block_phases::STOP_ALL, info, stream);
}
