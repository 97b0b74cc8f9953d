// The cross-split sums of the weight gradient, shared by the bf16 kernel
// (gemm.cu::wgrad_kernel) and the float32 one (gemm_f32.cu::
// wgrad_f32_kernel).
//
// Both kernels split M over CTAs (grid (splits, tiles), clusters of up to
// MAX_CLUSTER CTAs along the splits) and leave each split's float32 tile in
// its idle ring; sum_tile adds the splits in an order fixed by the grid, so
// two calls give the same bits, and with no atomics on the sums and no
// second launch.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace wgrad_sum {

constexpr int MAX_CLUSTER = 8;  // CTAs of a cluster (the portable limit)

// Copy 4 bytes from global to shared memory without registers (src_bytes
// 0 writes zeros): the scales ride the ring instead of stalling a warp.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The sums of a weight-gradient tile, after each CTA has written its partial
// tile to its idle ring (Cs: BN rows of BK floats at a stride of BK + 4,
// then Bs: BN floats of db where with_bias): the cluster adds its CTAs'
// tiles in rank order through distributed shared memory, rank r taking rows
// [r·BN/cl, +BN/cl) of the tile; with one cluster per tile those rows are
// dW itself, else the cluster's partial, and the last cluster to finish a
// tile's row slice (an arrival counter) adds the clusters' partials in
// cluster order. Every sum runs in an order fixed by the grid, so two calls
// give the same bits.
template <int BN, int BK, int NT>
__device__ __forceinline__ void sum_tile(unsigned char* smem_raw, float* __restrict__ dw,
                                         float* __restrict__ db, float* __restrict__ part_w,
                                         float* __restrict__ part_b,
                                         int* __restrict__ arrivals, int N, int K, int tile,
                                         int nt, int n0, int k0, bool with_bias) {
  constexpr int LDC = BK + 4;
  __shared__ int last;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  float (*Cs)[LDC] = reinterpret_cast<float (*)[LDC]>(smem_raw);
  float* Bs = &Cs[BN][0];
  cluster.sync();  // every CTA of the cluster holds its tile

  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int rows = BN / cl, r0 = rank * rows;
  const int clusters = gridDim.x / cl, cid = blockIdx.x / cl;
  // Rank r sums rows [r0, r0 + rows) over the cluster's CTAs in rank order,
  // into dW directly or into the cluster's partial.
  float* pw = part_w + ((size_t)tile * clusters + cid) * BN * BK;
  float* pb = part_b + ((size_t)nt * clusters + cid) * BN;
  for (int idx = tid; idx < rows * (BK / 4); idx += NT) {
    const int r = r0 + idx / (BK / 4), c = idx % (BK / 4) * 4;
    float4 v[MAX_CLUSTER];  // all loads in flight, then the sum in rank order
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < cl) v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(&Cs[r][c], q));
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < cl) s = add4(s, v[q]);
    if (clusters > 1) {
      *reinterpret_cast<float4*>(pw + r * BK + c) = s;
    } else if (n0 + r < N) {
      const float e[4] = {s.x, s.y, s.z, s.w};
      for (int t = 0; t < 4 && k0 + c + t < K; ++t) dw[(size_t)(n0 + r) * K + k0 + c + t] = e[t];
    }
  }
  if (with_bias && tid < rows) {
    float v[MAX_CLUSTER], s = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < cl) v[q] = *cluster.map_shared_rank(&Bs[r0 + tid], q);
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < cl) s += v[q];
    if (clusters > 1) pb[r0 + tid] = s;
    else if (n0 + r0 + tid < N) db[n0 + r0 + tid] = s;
  }
  cluster.sync();  // no CTA leaves while another still reads its tile
  if (clusters == 1) return;

  // The last cluster to deliver this row slice adds the partials in cluster order.
  __threadfence();
  __syncthreads();
  int* arrived = arrivals + (size_t)tile * MAX_CLUSTER + rank;
  if (tid == 0) last = atomicAdd(arrived, 1) == clusters - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* pw0 = part_w + (size_t)tile * clusters * BN * BK;
  for (int idx = tid; idx < rows * (BK / 4); idx += NT) {
    const int r = r0 + idx / (BK / 4), c = idx % (BK / 4) * 4;
    if (n0 + r >= N) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = 0; q0 < clusters; q0 += 8) {  // eight loads in flight, summed in order
      float4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < clusters)
          v[q] = __ldcg(reinterpret_cast<const float4*>(pw0 + ((size_t)(q0 + q) * BN + r) * BK + c));
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < clusters) s = add4(s, v[q]);
    }
    const float e[4] = {s.x, s.y, s.z, s.w};
    for (int t = 0; t < 4 && k0 + c + t < K; ++t) dw[(size_t)(n0 + r) * K + k0 + c + t] = e[t];
  }
  if (with_bias && tid < rows && n0 + r0 + tid < N) {
    const float* pb0 = part_b + (size_t)nt * clusters * BN;
    float s = 0.f;
    for (int q0 = 0; q0 < clusters; q0 += 8) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < clusters) v[q] = __ldcg(pb0 + (size_t)(q0 + q) * BN + r0 + tid);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < clusters) s += v[q];
    }
    db[n0 + r0 + tid] = s;
  }
  if (tid == 0) *arrived = 0;  // ready for the next call on the stream
}

// The cluster launch of a weight-gradient kernel over grid (splits, tiles)
// of `threads` threads and `smem` bytes of dynamic shared memory; `probe`
// asks only how many clusters of that size fit on the card at once.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int splits, int tiles, int cluster, int threads,
                            size_t smem, cudaStream_t stream, int* probe, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)tiles, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (probe != nullptr) return cudaOccupancyMaxActiveClusters(probe, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wgrad_sum
