// The pair kernel's body, launch and dispatch, templated on the
// activations' type: block_pair.cu instantiates the bf16 pair
// (cswin_block_pair), block_pair_f32.cu the float32 one
// (cswin_block_pair_f32), so that the two build in parallel. The design is
// documented at the top of block_pair.cu.
#pragma once

#include "block_phases.cuh"

namespace {

using namespace block_phases;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
block_pair_kernel(const T* x, BlockWT<T> p1, BlockWT<T> p2, PlanT<T> plan1, PlanT<T> plan2,
                  ScratchT<T> s, T* out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  block<D, attn_tile::FULL>(grid, x, p1, s, s.mid, g, plan1, smem);
  grid.sync();
  block<D, attn_tile::FULL>(grid, (const T*)s.mid, p2, s, out, g, plan2, smem);
}

// The float32 instance, held to F32_CTAS CTAs an SM (170 registers a
// thread at 3): the phases' union otherwise takes 255 registers and two
// CTAs an SM, and the 392 output tiles of proj and fc2 at tiny-224's stage
// 3 (B = 32) then run in two rounds of 264 CTAs, against one round of 396.
constexpr int F32_CTAS = 3;

template <int D>
__global__ void __launch_bounds__(THREADS, F32_CTAS)
block_pair_f32_kernel(const float* x, BlockWT<float> p1, BlockWT<float> p2,
                      PlanT<float> plan1, PlanT<float> plan2, ScratchT<float> s, float* out,
                      Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  block<D, attn_tile::FULL>(grid, x, p1, s, s.mid, g, plan1, smem);
  grid.sync();
  block<D, attn_tile::FULL>(grid, (const float*)s.mid, p2, s, out, g, plan2, smem);
}

// stop: the first block's last phase (Stop); short of STOP_ALL the second
// block runs no phase (the float32 instance's phases timed one by one).
template <typename T, int D>
int launch(const T* x, const void* const* params, T* scratch, T* out, const Geom& g,
           int stop, int* info, cudaStream_t stream) {
  const size_t mc = (size_t)g.B * g.H * g.W * g.C;
  ScratchT<T> s{scratch, scratch + mc, scratch + mc, scratch + 5 * mc, scratch,
                scratch + 6 * mc};
  BlockWT<T> p1 = unpack<T>(params), p2 = unpack<T>(params + 16);
  PlanT<T> plan1 = full_dual_plan(p1, g), plan2 = full_dual_plan(p2, g);
  plan1.stop = stop;
  if (stop < STOP_ALL) plan2.stop = STOP_NONE;
  Geom geom = g;
  void* args[] = {(void*)&x, &p1, &p2, &plan1, &plan2, &s, (void*)&out, &geom};
  const int L = (g.H > g.W ? g.H : g.W) * g.split;
  const size_t smem = block_phases::smem_bytes<D, T>(L);
  if constexpr (std::is_same_v<T, float>)
    return launch_cooperative(block_pair_f32_kernel<D>, smem, args, info, stream);
  else
    return launch_cooperative(block_pair_kernel<T, D>, smem, args, info, stream);
}

template <typename T>
int dispatch(const void* x, const void* const* params, void* scratch, void* out, int B,
             int H, int W, int C, int heads, int split, float scale, float eps, int stop,
             int* info, void* stream) {
  if (split >= H || H % split || W % split || !ln_row::supported<T>(C) || heads % 2 ||
      C % heads || (std::is_same_v<T, float> && C > F32_MAX_C) || (stop != STOP_QKV && stop != STOP_ATTENTION && stop != STOP_PROJ &&
                    stop != STOP_ALL))
    return (int)cudaErrorInvalidValue;
  const Geom g{B, H, W, C, heads, split, scale, eps};
  const T* xt = (const T*)x;
  T* st = (T*)scratch;
  T* ot = (T*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (C / heads) {
    case 16: return launch<T, 16>(xt, params, st, ot, g, stop, info, s);
    case 24: return launch<T, 24>(xt, params, st, ot, g, stop, info, s);
    case 32: return launch<T, 32>(xt, params, st, ot, g, stop, info, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
