// LayerNorm over the channel axis of a (rows, C) bf16 tensor, forward and
// backward: LN1 and LN2 of the CSWin block chain; and their float32
// instances, for TPU.COMPUTE_DTYPE float32 (cswin_layernorm_f32,
// cswin_layernorm_bwd_f32).
//
// Forward: float32 statistics, out in the input's type (bf16 rounded,
// float32 as computed).
// Backward, per row, with float32 statistics recomputed from x:
//   dx = res + rstd·(dŷ − mean(dŷ) − x̂·mean(dŷ·x̂)),   dŷ = dy·γ
// and dγ = Σ dy·x̂, dβ = Σ dy over all rows, float32, summed in the kernel.
// `res` is the residual stream's gradient that the block adds here (dout
// for LN2, dx1 for LN1), or null.
//
// Replaces: the two in-kernel LayerNorms of the fused TPU block,
//   cswin_unet_tpu/ops/pallas/cswin_block.py::_block_kernel_xt /
//   _block_kernel (via _layernorm), reference composition composed_block;
//   and their backward in ::_block_bwd_kernel_xt (via _ln_bwd, :586-601).
// Bound on the H100: memory bandwidth — the forward reads and writes each
//   element once (2 + 2 bytes, 4 + 4 at float32) and does ~8 flops on it;
//   the backward reads
//   x, dy and res and writes dx (8 bytes, 16 at float32) for ~15 flops.
// Design: the forward is one launch of one wave of CTAs (the entry sizes it
//   with the occupancy API, once an instance and device) that stride over
//   the rows; its row body lives in layernorm_row.cuh, shared with the
//   persistent kernels: a group of G lanes takes a row in 16-byte vectors
//   held in registers (x read once), two-pass statistics from registers
//   with shuffles inside the group, γ / β held across rows, the next row's
//   loads in flight, 16-byte stores; seven bf16 (G, V) instances serve
//   every C % 8 == 0 up to 1024, and nine float32 ones (16-byte vectors of
//   4 values) every C % 4 == 0 up to 1024.
//   The backward is one launch of one wave of CTAs (the wrapper sizes it
//   with the occupancy API) that stride over the rows. The channels a lane
//   holds are a template parameter (Shape<T, C>), so registers fit the row: a
//   group of G lanes takes a row in 16-byte vectors (C = 64: 8 lanes, a warp
//   4 rows at once) and reduces it with shuffles inside the group, with the
//   group's next row's loads issued before this row's reductions. dγ / dβ
//   are summed in a fixed order without float atomics: lanes over the rows
//   they took, groups of a warp by a butterfly, warps through shared
//   memory, then in two levels: the last CTA to arrive of each group of 16
//   (a counter read after a fence, reset by that CTA) adds the group's
//   partial rows in CTA order, and the last group the groups' rows in group
//   order, so that no one CTA reads all the partials from L2. Two calls
//   give the same bits. The float32 instances run the same kernel on
//   16-byte vectors of 4 floats and write dx unrounded; at C = 768 their
//   lanes hold twice the bytes of a row, so they issue the next row's loads
//   only after this row's (PREFETCH): the registers then fit without
//   spilling.

#include "layernorm_row.cuh"

// Both kernels live in the anonymous namespace, as every kernel of the
// library does: the profiler then names them "(anonymous namespace)::...".
namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;

template <typename T, int G, int V>
__global__ void __launch_bounds__(THREADS)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, T* __restrict__ y, int rows, int C,
                 float eps) {
  ln_row::rows<G, V>(x, C, w, b, y, C, rows, C, eps, THREADS, blockIdx.x, gridDim.x);
}

// One wave of layernorm_kernel<T, G, V> over the rows: the CTAs an SM holds
// (the occupancy API, asked once an instance and device) times the SMs,
// fewer where the rows run out first.
template <typename T, int G, int V>
cudaError_t launch_fwd(const T* x, const float* w, const float* b, T* y, int rows,
                       int C, float eps, cudaStream_t stream) {
  static int fit_dev = -1, fit_ctas = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != fit_dev) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, layernorm_kernel<T, G, V>, THREADS, 0)) != cudaSuccess)
      return err;
    fit_ctas = per_sm * sms;
    fit_dev = dev;
  }
  const int step = THREADS / G, steps = (rows + step - 1) / step;
  const int grid = steps < fit_ctas ? steps : fit_ctas;
  if (grid < 1) return cudaErrorInvalidValue;
  layernorm_kernel<T, G, V><<<grid, THREADS, 0, stream>>>(x, w, b, y, rows, C, eps);
  return cudaGetLastError();
}

constexpr int GROUP = 16;  // CTAs whose partial rows the last of them adds

// How the backward cuts a row of C channels (C % 32 == 0, C <= 512, or
// C = 768, base-384's last stage) of T (bf16 or float): N 16-byte vectors
// of E values (8 bf16, 4 float); G lanes a row (the power of two >= N, at
// most 32), V vectors a lane (lane j of a group holds vectors j, j + G,
// ...; past N it holds none); ROWS rows a CTA takes per step, one a group.
// PAIRS: the CTA's dγ and dβ rows go through shared memory together (else
// one after the other, so that 768 channels of eight warps fit in the 48 KB
// of static shared memory). PREFETCH: the next row's loads are in flight
// during this row's arithmetic (not for float32 rows wider than 512).
// Mirrored by kernels.py::layernorm_bwd_plan.
template <typename T, int C>
struct Shape {
  static_assert(C % 32 == 0 && (C <= 512 || C == 768), "C % 32 == 0, C <= 512 or C = 768");
  static constexpr int E = 16 / sizeof(T);
  static constexpr int N = C / E;
  static constexpr int G = N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32;
  static constexpr int V = (N + G - 1) / G;
  static constexpr int ROWS = THREADS / G;
  static constexpr int PAIRS = C <= 512 ? 2 : 1;
  static constexpr bool PREFETCH = sizeof(T) == 2 || C <= 512;
};

// A 16-byte vector of E values of T as floats; 4 floats as a vector.
__device__ __forceinline__ void unpack_vec(const uint4& u, float (&f)[8]) { unpack8(u, f); }
__device__ __forceinline__ void unpack_vec(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack_vec(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

using ln_row::group_sum;

// Whether this CTA is the last of `n` to arrive at `counter`, after its
// stores (fenced) and before its loads of the others' (fenced again).
__device__ __forceinline__ bool arrive(int* counter, int n, bool& last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Adds rows [b0, b1) of 2C floats at `rows` in row order into acc, float4
// column `col`, eight loads in flight.
template <int C>
__device__ __forceinline__ void add_rows(const float* rows, int b0, int b1, int col,
                                         float4& acc) {
  for (int q0 = b0; q0 < b1; q0 += 8) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q0 + q < b1)
        v[q] = __ldcg(reinterpret_cast<const float4*>(rows + (size_t)(q0 + q) * 2 * C) + col);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q0 + q < b1) {
        acc.x += v[q].x;
        acc.y += v[q].y;
        acc.z += v[q].z;
        acc.w += v[q].w;
      }
  }
}

// dst = the sum of n rows of 2C floats at `rows`, in row order: float4
// columns, the rows cut into SLICES runs summed in order, then the runs in
// order. Wider than a float4 column a thread (C = 768): a thread sums each
// of its columns over all n rows in order.
template <int C>
__device__ __forceinline__ void sum_rows(const float* rows, int n, float* dst, float4* fin) {
  constexpr int COLS = 2 * C / 4;
  const int tid = threadIdx.x;
  if constexpr (COLS > THREADS) {
    for (int col = tid; col < COLS; col += THREADS) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      add_rows<C>(rows, 0, n, col, acc);
      reinterpret_cast<float4*>(dst)[col] = acc;
    }
  } else {
    constexpr int SLICES = THREADS / COLS;
    const int col = tid % COLS, slice = tid / COLS;
    const int run = (n + SLICES - 1) / SLICES;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (slice < SLICES) add_rows<C>(rows, slice * run, min(n, slice * run + run), col, acc);
    fin[tid] = acc;
    __syncthreads();
    if (tid < COLS) {
      float4 sum = fin[tid];
      for (int k = 1; k < SLICES; ++k) {
        const float4 f = fin[k * COLS + tid];
        sum.x += f.x;
        sum.y += f.y;
        sum.z += f.z;
        sum.w += f.w;
      }
      reinterpret_cast<float4*>(dst)[tid] = sum;
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ w, const T* __restrict__ res,
                     T* __restrict__ dx, float* __restrict__ out,
                     int* __restrict__ arrival, int rows, float eps) {
  using S = Shape<T, C>;
  constexpr int G = S::G, V = S::V, N = S::N, E = S::E;
  __shared__ float red[S::PAIRS][WARPS][C];
  __shared__ float4 fin[THREADS];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = lane % G, group = tid / G;

  bool has[V];
  float gam[V][E], gw[V][E], gb[V][E];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    has[v] = v * G + j < N;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      gam[v][e] = has[v] ? w[(v * G + j) * E + e] : 0.f;
      gw[v][e] = gb[v][e] = 0.f;
    }
  }

  // A row's raw 16-byte vectors: x, dy, res.
  struct Row {
    uint4 x[V], dy[V], res[V];
  };
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const auto load = [&](int row, Row& t) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const bool ok = row < rows && has[v];
      const size_t o = (size_t)row * C + (v * G + j) * E;
      t.x[v] = ok ? *reinterpret_cast<const uint4*>(x + o) : zero;
      t.dy[v] = ok ? *reinterpret_cast<const uint4*>(dy + o) : zero;
      t.res[v] = ok && res != nullptr ? *reinterpret_cast<const uint4*>(res + o) : zero;
    }
  };

  const int steps = (rows + S::ROWS - 1) / S::ROWS;
  Row cur;
  if ((int)blockIdx.x < steps) load(blockIdx.x * S::ROWS + group, cur);
  for (int step = blockIdx.x; step < steps; step += gridDim.x) {
    const int row = step * S::ROWS + group, next = step + (int)gridDim.x;
    Row nxt;
    if constexpr (S::PREFETCH) {
      if (next < steps) load(next * S::ROWS + group, nxt);  // in flight below
    }
    float xh[V][E], s = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      unpack_vec(cur.x[v], xh[v]);
#pragma unroll
      for (int e = 0; e < E; ++e) s += xh[v][e];
    }
    const float mu = group_sum<G>(s) / C;
    float var = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = has[v] ? xh[v][e] - mu : 0.f;
        var += d * d;
      }
    const float rstd = rsqrtf(group_sum<G>(var) / C + eps);
    const bool ok = row < rows;
    float m1 = 0.f, m2 = 0.f, dh[V][E];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float g[E];
      unpack_vec(cur.dy[v], g);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        xh[v][e] = (xh[v][e] - mu) * rstd;
        if (ok) {
          gw[v][e] += g[e] * xh[v][e];
          gb[v][e] += g[e];
        }
        dh[v][e] = g[e] * gam[v][e];
        m1 += dh[v][e];
        m2 += dh[v][e] * xh[v][e];
      }
    }
    m1 = group_sum<G>(m1) / C;
    m2 = group_sum<G>(m2) / C;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!ok || !has[v]) continue;
      float rv[E];
      unpack_vec(cur.res[v], rv);
      uint4* out_v = reinterpret_cast<uint4*>(dx + (size_t)row * C + (v * G + j) * E);
      if constexpr (E == 8) {
        // Each pair rounded as it is made: the order in which nvcc contracts
        // this body, and so the bf16 bits of dx, depend on it.
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * i + h;
            a[h] = rstd * (dh[v][e] - m1 - xh[v][e] * m2);
            if (res != nullptr) a[h] += rv[e];
          }
          o[i] = pack_bf16(a[0], a[1]);
        }
        *out_v = make_uint4(o[0], o[1], o[2], o[3]);
      } else {
        float a[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          a[e] = rstd * (dh[v][e] - m1 - xh[v][e] * m2);
          if (res != nullptr) a[e] += rv[e];
        }
        *out_v = pack_vec(a);
      }
    }
    if constexpr (S::PREFETCH) {
      cur = nxt;
    } else if (next < steps) {
      load(next * S::ROWS + group, cur);
    }
  }

  // The CTA's partial row: the groups of a warp (same channels, lanes j
  // apart by G), then the warps in order.
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {
        gw[v][e] += __shfl_xor_sync(0xffffffffu, gw[v][e], o);
        gb[v][e] += __shfl_xor_sync(0xffffffffu, gb[v][e], o);
      }
  // out: dγ (C), dβ (C), then gridDim.x partial rows of 2C, then a row a
  // group of GROUP CTAs.
  float* part = out + 2 * C;
  float* group_part = part + (size_t)gridDim.x * 2 * C;
  const bool alone = gridDim.x == 1;
  float* mine = alone ? out : part + (size_t)blockIdx.x * 2 * C;
  // dγ and dβ together (PAIRS = 2), or one pass each (PAIRS = 1); each
  // channel's sum runs over the warps in order either way.
  for (int p0 = 0; p0 < 2; p0 += S::PAIRS) {
    if (lane < G) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (has[v])
#pragma unroll
          for (int e = 0; e < E; ++e)
#pragma unroll
            for (int q = 0; q < S::PAIRS; ++q)
              red[q][warp][(v * G + j) * E + e] = p0 + q == 0 ? gw[v][e] : gb[v][e];
    }
    __syncthreads();
    for (int c = tid; c < S::PAIRS * C; c += THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) sum += red[c / C][k][c % C];
      mine[p0 * C + c] = sum;
    }
    if (p0 + S::PAIRS < 2) __syncthreads();  // red is written again
  }
  if (alone) return;

  // The last CTA of each group adds its group's rows in CTA order; the
  // last group to finish adds the groups' rows in group order. A counter
  // read after a fence tells each who is last, and the last resets it.
  const int groups = (gridDim.x + GROUP - 1) / GROUP, grp = blockIdx.x / GROUP;
  const int g0 = grp * GROUP, gn = min((int)gridDim.x, g0 + GROUP) - g0;
  if (!arrive(arrival + 1 + grp, gn, last)) return;
  sum_rows<C>(part + (size_t)g0 * 2 * C, gn, groups == 1 ? out : group_part + (size_t)grp * 2 * C,
              fin);
  if (tid == 0) arrival[1 + grp] = 0;  // ready for the next call on the stream
  if (groups == 1 || !arrive(arrival, groups, last)) return;
  sum_rows<C>(group_part, groups, out, fin);
  if (tid == 0) arrival[0] = 0;
}

}  // namespace

// x, y: (rows, C) bf16, 16-byte aligned; w, b: (C,) float32. C % 8 == 0,
// C <= 1024 (ln_row::supported; checked by the wrapper), rows >= 1.
CSWIN_API int cswin_layernorm(const void* x, const void* w, const void* b,
                              void* y, int rows, int C, float eps,
                              void* stream) {
  if (!ln_row::supported(C) || rows < 1) return (int)cudaErrorInvalidValue;
  const bf16* xb = (const bf16*)x;
  const float *wf = (const float*)w, *bf = (const float*)b;
  bf16* yb = (bf16*)y;
  const cudaStream_t s = (cudaStream_t)stream;
#define CSWIN_LN_FWD(G, V) (int)launch_fwd<bf16, G, V>(xb, wf, bf, yb, rows, C, eps, s)
  return LN_ROW_INSTANCE(C, CSWIN_LN_FWD);
#undef CSWIN_LN_FWD
}

// The float32 instances (TPU.COMPUTE_DTYPE float32): x, y (rows, C) float32,
// 16-byte aligned; w, b as above. C % 4 == 0, C <= 1024
// (ln_row::supported<float>; checked by the wrapper), rows >= 1.
CSWIN_API int cswin_layernorm_f32(const void* x, const void* w, const void* b, void* y,
                                  int rows, int C, float eps, void* stream) {
  if (!ln_row::supported<float>(C) || rows < 1) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float *wf = (const float*)w, *bf = (const float*)b;
  float* yf = (float*)y;
  const cudaStream_t s = (cudaStream_t)stream;
#define CSWIN_LN_FWD(G, V) (int)launch_fwd<float, G, V>(xf, wf, bf, yf, rows, C, eps, s)
  return LN_ROW_INSTANCE_F32(C, CSWIN_LN_FWD);
#undef CSWIN_LN_FWD
}

#define CSWIN_LN_BWD_CHANNELS(X) \
  X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256) X(288) X(320) X(352) X(384) \
  X(416) X(448) X(480) X(512) X(768)

// x, dy, res, dx: (rows, C) bf16, 16-byte aligned (res may be null); w: (C,)
// float32; out: float32, dγ (C), dβ (C), then `grid` partial rows of 2C
// and ceil(grid / 16) group rows of 2C (unused when grid == 1); arrival:
// 1 + ceil(grid / 16) ints, zero, left zero. `grid` CTAs of 256 threads;
// C % 32 == 0, C <= 512 or C = 768 (checked by the wrapper).
// cswin_layernorm_bwd_f32: the same with x, dy, res and dx float32.
template <typename T>
static int ln_bwd_entry(const void* x, const void* dy, const void* w, const void* res, void* dx,
                        void* out, void* arrival, int rows, int C, int grid, float eps,
                        void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
#define CSWIN_LN_BWD(CH)                                                                \
  case CH:                                                                              \
    layernorm_bwd_kernel<T, CH><<<grid, THREADS, 0, (cudaStream_t)stream>>>(            \
        (const T*)x, (const T*)dy, (const float*)w, (const T*)res, (T*)dx, (float*)out, \
        (int*)arrival, rows, eps);                                                      \
    return (int)cudaGetLastError();
  switch (C) { CSWIN_LN_BWD_CHANNELS(CSWIN_LN_BWD) }
#undef CSWIN_LN_BWD
  return (int)cudaErrorInvalidValue;
}

// CTAs of the backward for T at C that an SM runs at once (the occupancy
// API), or -1: what sizes the wrapper's one wave.
template <typename T>
static int ln_bwd_ctas_per_sm(int C) {
  int n = -1;
  cudaError_t err = cudaErrorInvalidValue;
#define CSWIN_LN_BWD(CH)                                                                     \
  case CH:                                                                                   \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, layernorm_bwd_kernel<T, CH>, \
                                                        THREADS, 0);                     \
    break;
  switch (C) { CSWIN_LN_BWD_CHANNELS(CSWIN_LN_BWD) }
#undef CSWIN_LN_BWD
  return err == cudaSuccess ? n : -1;
}

CSWIN_API int cswin_layernorm_bwd(const void* x, const void* dy, const void* w,
                                  const void* res, void* dx, void* out, void* arrival,
                                  int rows, int C, int grid, float eps, void* stream) {
  return ln_bwd_entry<bf16>(x, dy, w, res, dx, out, arrival, rows, C, grid, eps, stream);
}

CSWIN_API int cswin_layernorm_bwd_f32(const void* x, const void* dy, const void* w,
                                      const void* res, void* dx, void* out, void* arrival,
                                      int rows, int C, int grid, float eps, void* stream) {
  return ln_bwd_entry<float>(x, dy, w, res, dx, out, arrival, rows, C, grid, eps, stream);
}

CSWIN_API int cswin_layernorm_bwd_ctas_per_sm(int C) { return ln_bwd_ctas_per_sm<bf16>(C); }

CSWIN_API int cswin_layernorm_bwd_f32_ctas_per_sm(int C) {
  return ln_bwd_ctas_per_sm<float>(C);
}
