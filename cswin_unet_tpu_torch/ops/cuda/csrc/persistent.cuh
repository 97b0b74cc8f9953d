// Host-side helpers of the persistent kernels that size their grid from the
// occupancy API (lepe_windows.cu, ln_mlp.cu): one wave of CTAs, each walking
// tiles cta, cta + grid, ...
#pragma once

#include <mutex>

#include "common.cuh"

namespace persistent {

constexpr int SMEM_MAX = 232448;  // the H100's 227 KB a block

// CTAs an SM of `kernel` launched with `threads` threads and `smem` bytes of
// dynamic shared memory, and the current device's SM count. Asked once per
// (device, kernel, smem): the answer does not change, and a launch of a
// kernel whose work takes microseconds should not pay for the question. The
// kernel is first allowed the whole 227 KB, so that any smem up to it can be
// launched.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int smem, int& ctas, int& sms) {
  struct Entry {
    int dev;
    const void* fn;
    int threads, smem, ctas, sms;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& c = cache[i];
    if (c.dev == dev && c.fn == fn && c.threads == threads && c.smem == smem) {
      ctas = c.ctas;
      sms = c.sms;
      return cudaSuccess;
    }
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  if (used < 64) cache[used++] = Entry{dev, fn, threads, smem, ctas, sms};
  return cudaSuccess;
}

}  // namespace persistent
