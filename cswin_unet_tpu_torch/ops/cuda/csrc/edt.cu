// Exact 1-D squared-EDT min-plus pass along one axis of a float32 volume:
//   g[i] = min_j (i - j)^2 + f[j]
// with the volume contiguous and viewed as (outer, L, inner), the pass
// running along L. Three passes (one per axis) give the exact squared
// euclidean distance transform (ops/edt.py::edt_sq).
//
// Replaces: cswin_unet_tpu/ops/edt.py::edt_pass (pallas_call :73, body
//   _edt_pass_kernel :32), which passes along the last axis only and needs
//   moveaxis copies for the others; here any axis is read in place.
// Bound on the H100: brute force is L candidates per output and 3 float32
//   operations per candidate (d·d + f as one FMA, then a min). At L = 512
//   that is ~1,500 operations per 8 bytes moved (one read, one write), so
//   the float32 rate (67 TFLOP/s), not memory, bounds it. The exact O(L)
//   lower-envelope pass (Felzenszwalb-Huttenlocher) is the later redesign.
// Design: a block takes 32 lines and stages all L values of each in shared
//   memory, S[j][k] with a padded row so that both staging orders are free
//   of bank conflicts. Along the last axis (inner == 1) a warp walks one line
//   with its lanes on 32 outputs and reads f[j] as a broadcast; along any
//   other axis the lanes are the 32 lines (neighbouring columns, coalesced)
//   and the warps walk rows. Each thread keeps R outputs in registers, so
//   one shared-memory read feeds R independent min chains. The distance is
//   a float counted in steps of 1 (exact below 2^24), so every candidate is
//   the same float32 sum as the plain version's and min is exact: the
//   result equals it bit for bit.

#include "common.cuh"

namespace {

constexpr int TL = 32;      // lines per block
constexpr int LD = TL + 1;  // padded row of the staged tile
constexpr int WARPS = 8;
constexpr int R = 4;        // outputs per thread per sweep over j

template <bool LAST>
__global__ void __launch_bounds__(WARPS * 32)
edt_pass_kernel(const float* __restrict__ f, float* __restrict__ g, long long n_lines,
                int L, long long inner) {
  extern __shared__ float S[];  // S[j * LD + k]: element j of the tile's line k
  const long long line0 = (long long)blockIdx.x * TL;
  const int lines = (int)(n_lines - line0 < TL ? n_lines - line0 : TL);
  const int tid = threadIdx.x;

  if (LAST) {  // line k is the contiguous row line0 + k: read along j
    for (int idx = tid; idx < lines * L; idx += WARPS * 32) {
      const int k = idx / L, j = idx - k * L;
      S[j * LD + k] = f[(line0 + k) * L + j];
    }
  } else {     // neighbouring lines are neighbouring columns: read along k
    for (int idx = tid; idx < lines * L; idx += WARPS * 32) {
      const int j = idx / lines, k = idx - j * lines;
      const long long t = line0 + k;
      S[j * LD + k] = f[(t / inner) * L * inner + (long long)j * inner + t % inner];
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  if (LAST) {
    for (int k = warp; k < lines; k += WARPS) {
      float* out = g + (line0 + k) * L;
      for (int i0 = 0; i0 < L; i0 += 32 * R) {
        float fi[R], m[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          fi[r] = (float)(i0 + lane + 32 * r);
          m[r] = INFINITY;
        }
        float fj = 0.f;
        for (int j = 0; j < L; ++j, fj += 1.f) {
          const float s = S[j * LD + k];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float d = fi[r] - fj;
            m[r] = fminf(m[r], d * d + s);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = i0 + lane + 32 * r;
          if (i < L) out[i] = m[r];
        }
      }
    }
  } else if (lane < lines) {
    const long long t = line0 + lane;
    float* out = g + (t / inner) * L * inner + t % inner;
    for (int i0 = warp * R; i0 < L; i0 += WARPS * R) {
      float fi[R], m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fi[r] = (float)(i0 + r);
        m[r] = INFINITY;
      }
      float fj = 0.f;
      for (int j = 0; j < L; ++j, fj += 1.f) {
        const float s = S[j * LD + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d = fi[r] - fj;
          m[r] = fminf(m[r], d * d + s);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r < L) out[(long long)(i0 + r) * inner] = m[r];
      }
    }
  }
}

template <bool LAST>
cudaError_t launch(const float* f, float* g, long long n_lines, int L, long long inner,
                   cudaStream_t stream) {
  const size_t smem = (size_t)L * LD * sizeof(float);
  cudaError_t err = allow_smem(edt_pass_kernel<LAST>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_lines + TL - 1) / TL;
  edt_pass_kernel<LAST><<<(unsigned)blocks, WARPS * 32, smem, stream>>>(f, g, n_lines,
                                                                        L, inner);
  return cudaGetLastError();
}

}  // namespace

// f, g: contiguous float32 (outer, L, inner); g may not alias f. L * 33 * 4
// bytes of shared memory per block (L <= 1,760 on an H100).
CSWIN_API int cswin_edt_pass(const void* f, void* g, long long outer, int L,
                             long long inner, void* stream) {
  const long long n_lines = outer * inner;
  if (n_lines <= 0 || L <= 0 || (n_lines + TL - 1) / TL > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (inner == 1) return (int)launch<true>((const float*)f, (float*)g, n_lines, L, inner, s);
  return (int)launch<false>((const float*)f, (float*)g, n_lines, L, inner, s);
}
