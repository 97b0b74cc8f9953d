// The float32 instance of the pair kernel (TPU.COMPUTE_DTYPE float32): two
// dual-branch blocks in one cooperative launch on the float32 tiles
// (layernorm_row.cuh at float, gemm_f32_tile.cuh, attn_tile::tile_f32),
// equal to two float32 block chains bit for bit. The kernel and its design
// are block_pair.cu's (block_pair.cuh); this file only builds the float32
// instance beside the bf16 one.

#include "block_pair.cuh"

// The float32 instance (TPU.COMPUTE_DTYPE float32): x, out and scratch
// (7·B·H·W·C) float32; params as above with the matrices, LePE taps and
// LePE biases float32; C % 4 == 0 (ln_row::supported<float>). Equal to two
// float32 block chains bit for bit: the same float32 tiles. stop: 7
// (block_phases::STOP_ALL) runs the pair; 2, 3 or 4 (STOP_QKV,
// STOP_ATTENTION, STOP_PROJ) only the first block's phases up to that one,
// so that the phases can be timed one by one.
CSWIN_API int cswin_block_pair_f32(const void* x, const void* const* params, void* scratch,
                                   void* out, int B, int H, int W, int C, int heads,
                                   int split, float scale, float eps, int stop, int* info,
                                   void* stream) {
  return dispatch<float>(x, params, scratch, out, B, H, W, C, heads, split, scale, eps, stop,
                         info, stream);
}
