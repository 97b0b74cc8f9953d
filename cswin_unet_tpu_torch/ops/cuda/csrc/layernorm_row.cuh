// The forward LayerNorm's rows, as device functions shared by every kernel
// that normalises: the one-launch layernorm_kernel (layernorm.cu), the LN
// phases of the persistent whole-block kernels (block_phases.cuh) and the
// normalisation into shared memory of ln_mlp.cu. One body, so that they all
// round the same way: float32 two-pass mean / variance as the reference
// computes them, (x − μ)·rsqrt(var + eps)·γ + β, out in the row's element
// type T: bf16 (rounded) or float (TPU.COMPUTE_DTYPE float32: as computed).
//
// A group of G lanes takes a row in 16-byte vectors of E = 16 / sizeof(T)
// values, 8 bf16 or 4 float (lane j of a group holds vectors j, j + G,
// ...), so the row is read once, into
// registers; the mean and the variance are summed over the lane's values in
// order and then across the group by a butterfly of shuffles; γ and β stay
// in registers across the rows a thread takes, and the next row's loads are
// issued before this row's reductions. The output leaves in 16-byte stores.
// The instances are (T, G, V), lanes a row and vectors a lane, not C: seven
// bf16 ones serve every C % 8 == 0 up to 1024, nine float ones every
// C % 4 == 0 up to 1024 (mirrored by kernels.py::layernorm_fwd_plan). The
// sum order depends on (T, G, V) only, so every caller gives the same bits
// for the same row.
#pragma once

#include "common.cuh"

namespace ln_row {

constexpr int MAX_C = 1024;

// Values of T in a 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int E = 16 / (int)sizeof(T);
};

// Whether the forward takes rows of C channels of T.
template <typename T = bf16>
__host__ __device__ constexpr bool supported(int C) {
  return C > 0 && C % Vec<T>::E == 0 && C <= MAX_C;
}

// Sum over the G lanes of a group (G a power of two, groups aligned in the
// warp); every lane of the warp must take part.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, rows) of x (row stride ldx) normalised into y (row stride ldy),
// both 16-byte aligned rows; γ (w) and β (b) 16-byte aligned. The `threads` threads of the CTA take
// threads / G rows a step; this CTA takes steps first, first + stride, ...
// Every lane of a warp runs the loop (the shuffles), rows past the end
// load zeros and store nothing. HOLD: γ and β stay in registers across the
// rows; without it (the persistent kernels, whose other phases hold the
// registers) they are read from L1 where used: the same values, the same
// bits.
template <int G, int V, bool HOLD = true, typename T>
__device__ __forceinline__ void rows(const T* __restrict__ x, int ldx,
                                     const float* __restrict__ w,
                                     const float* __restrict__ b, T* __restrict__ y,
                                     int ldy, int nrows, int C, float eps, int threads,
                                     int first, int stride) {
  constexpr int E = Vec<T>::E;
  const int tid = threadIdx.x, j = tid % G, group = tid / G, R = threads / G;
  const int N = C / E, steps = (nrows + R - 1) / R;
  // γ / β of a vector: E / 4 float4 loads each (a lane's E channels are
  // 4·E contiguous bytes), not E scalar ones 4·E bytes apart across lanes.
  const auto params = [&](int v, float (&gv)[E], float (&bv)[E]) {
    const float4* w4 = reinterpret_cast<const float4*>(w + (v * G + j) * E);
    const float4* b4 = reinterpret_cast<const float4*>(b + (v * G + j) * E);
#pragma unroll
    for (int h = 0; h < E / 4; ++h) {
      const float4 wv = w4[h], bv4 = b4[h];
      gv[4 * h] = wv.x;
      gv[4 * h + 1] = wv.y;
      gv[4 * h + 2] = wv.z;
      gv[4 * h + 3] = wv.w;
      bv[4 * h] = bv4.x;
      bv[4 * h + 1] = bv4.y;
      bv[4 * h + 2] = bv4.z;
      bv[4 * h + 3] = bv4.w;
    }
  };
  bool has[V];
  float gam[HOLD ? V : 1][E], bet[HOLD ? V : 1][E];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    has[v] = v * G + j < N;
    if constexpr (HOLD) {
      if (has[v]) params(v, gam[v], bet[v]);
    }
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const auto load = [&](int row, uint4 (&u)[V]) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      u[v] = row < nrows && has[v]
                 ? *reinterpret_cast<const uint4*>(x + (size_t)row * ldx + (v * G + j) * E)
                 : zero;
  };
  uint4 cur[V];
  if (first < steps) load(first * R + group, cur);
  for (int step = first; step < steps; step += stride) {
    const int row = step * R + group, next = step + stride;
    uint4 nxt[V];
    load(next < steps ? next * R + group : nrows, nxt);  // in flight below
    float xf[V][E], s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if constexpr (E == 8) {
        unpack8(cur[v], xf[v]);
      } else {
        xf[v][0] = __uint_as_float(cur[v].x);
        xf[v][1] = __uint_as_float(cur[v].y);
        xf[v][2] = __uint_as_float(cur[v].z);
        xf[v][3] = __uint_as_float(cur[v].w);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) s += xf[v][e];
    }
    const float mu = group_sum<G>(s) / C;
    float var = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = has[v] ? xf[v][e] - mu : 0.f;
        var += d * d;
      }
    const float rstd = rsqrtf(group_sum<G>(var) / C + eps);
    if (row < nrows) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!has[v]) continue;
        float gv[E], bv[E];
        if constexpr (HOLD) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            gv[e] = gam[v][e];
            bv[e] = bet[v][e];
          }
        } else {
          params(v, gv, bv);
        }
        uint32_t o[4];
        if constexpr (E == 8) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[i] = pack_bf16((xf[v][2 * i] - mu) * rstd * gv[2 * i] + bv[2 * i],
                             (xf[v][2 * i + 1] - mu) * rstd * gv[2 * i + 1] + bv[2 * i + 1]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[i] = __float_as_uint((xf[v][i] - mu) * rstd * gv[i] + bv[i]);
        }
        *reinterpret_cast<uint4*>(y + (size_t)row * ldy + (v * G + j) * E) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) cur[v] = nxt[v];
  }
}

// The expression X(G, V) of the bf16 instance for C (supported(C)): G the
// power of two >= C / 8, from 4 to 32, V = ceil(C / 8 / G) <= 4.
#define LN_ROW_INSTANCE(C, X)                                                             \
  ((C) <= 32 ? X(4, 1) : (C) <= 64 ? X(8, 1) : (C) <= 128 ? X(16, 1) : (C) <= 256 ? X(32, 1) \
   : (C) <= 512 ? X(32, 2) : (C) <= 768 ? X(32, 3) : X(32, 4))

// The float instance for C (supported<float>(C)): G the power of two
// >= C / 4, from 4 to 32, V = ceil(C / 4 / G) rounded up to 1, 2, 3, 4, 6
// or 8 (base-384's last stage, C = 768, takes V = 6).
#define LN_ROW_INSTANCE_F32(C, X)                                                          \
  ((C) <= 16 ? X(4, 1) : (C) <= 32 ? X(8, 1) : (C) <= 64 ? X(16, 1) : (C) <= 128 ? X(32, 1) \
   : (C) <= 256 ? X(32, 2) : (C) <= 384 ? X(32, 3) : (C) <= 512 ? X(32, 4)                  \
   : (C) <= 768 ? X(32, 6) : X(32, 8))

// The rows through the instance for C; false (and nothing done) for a C the
// forward does not take.
template <bool HOLD = true, typename T>
__device__ __forceinline__ bool rows_any(const T* x, int ldx, const float* w,
                                         const float* b, T* y, int ldy, int nrows, int C,
                                         float eps, int threads, int first, int stride) {
  if (!supported<T>(C)) return false;
#define LN_ROWS(G, V) \
  (rows<G, V, HOLD>(x, ldx, w, b, y, ldy, nrows, C, eps, threads, first, stride), true)
  if constexpr (Vec<T>::E == 8)
    return LN_ROW_INSTANCE(C, LN_ROWS);
  else
    return LN_ROW_INSTANCE_F32(C, LN_ROWS);
#undef LN_ROWS
}

}  // namespace ln_row
