// Shared helpers for the hand-written Hopper kernels.
//
// Every entry point is a plain C function bound with ctypes: it takes raw
// device pointers, sizes and the caller's cudaStream_t (PyTorch's current
// stream), launches on that stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise when a
// launch was refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define CSWIN_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }
// Round a float32 through bf16 and back: the points where the reference
// rounds an intermediate to the activation dtype.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// --- sm_80+ building blocks of the tensor-core tiles (attention_tile.cuh,
// gemm_tile.cuh): asynchronous 16-byte copies into shared memory, ldmatrix
// and the bf16 mma.sync m16n8k16 with float32 accumulators. Fragment layouts
// are PTX's (g = lane / 4, q = lane % 4): A holds rows g and g + 8, columns
// 2q, 2q + 1 and 2q + 8, 2q + 9; B columns (n) g, rows (k) 2q, 2q + 1 and
// 2q + 8, 2q + 9; C rows g and g + 8, columns 2q and 2q + 1.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy 16 bytes from global to shared memory without registers; src_bytes
// 0 writes 16 zero bytes (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. TRANS: each matrix transposed.
template <bool TRANS = false>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}
// Two transposed matrices (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a · b, a 16x16 and b 16x8 in bf16, d 16x8 in float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// Eight bf16 values of a 16-byte vector as floats.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
// Both halves of a bf16x2 register multiplied by s and rounded back to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  const float2 f = unpack_bf16(v);
  return pack_bf16(f.x * s, f.y * s);
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
