// LePE alone: the depthwise 3x3 convolution on V inside each window, zero
// beyond the window's edge (not the image's).
//
//   out[b, y, x, ch] = bias[ch] + Σ_{di,dj ∈ {-1,0,1}} tap[di+1, dj+1, ch] ·
//                      v[b, y+di, x+dj, ch]
// over the neighbours that lie in the pixel's own (sp_h, sp_w) window. V is
// an image batch (B, H, W, c) tiled by windows; a stack of windows (n, L, c)
// is the case H = sp_h, W = sp_w. float32 accumulation, one rounding at the
// store. What the entry takes beyond that, each a formulation the TPU
// experiments priced or bisected:
//   - V read in place through a pixel stride, so it may be the last third of
//     a packed (.., 3c) qkv tensor (no copy);
//   - a second tap set and bias used from window index n0 on (two branches'
//     windows stacked on the batch axis);
//   - the channels split over two sources, [0, c_split) from v0 and the rest
//     from v1 (two branches stacked on channels), and with `fold` the two
//     channel halves of the result added, out[.., :c/2] + out[.., c/2:];
//   - taps and biases in float32 or bf16.
// A transposed tap grid (`swap`) is the wrapper's business: it hands the
// taps over already transposed.
//
// Replaces: the stand-alone LePE kernels of scripts/exp_lepe_mm.py:56 (k_flat,
//   k_mm), exp_mm_bisect.py:66 (rungs a-d, f), exp_mm_bisect2.py:94 (b0-b5),
//   exp_cs_bisect.py:111 (k_concat .. k_full) and exp_attn3.py:59 (k_lepe),
//   all bodies over cswin_unet_tpu/ops/pallas/cswin_block.py::_lepe_windows
//   (:289), _lepe_windows_dual (:476) and _lepe_windows_dual_cs (:529). The
//   shift, 0/1-matrix, one-tap and nine-product forms there are one function.
// Bound on the H100: bytes. 18 flops a value against 4 bytes moved (V read
//   once, the result written once), far below the card's ridge.
// Design: one thread per pixel and 8-channel chunk: up to nine 16-byte loads
//   of the neighbours (a window is at most a few tens of KB, so eight of the
//   nine come from L1 / L2), the taps from the read-only cache, eight float32
//   sums, one 16-byte store. No shared memory: the stencil's reuse is the
//   cache's. The window-edge predicates are those of attention_tile.cuh.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // bf16 values per 16-byte access

struct Geom {
  int H, W, sp_h, sp_w;
  int c;        // channels of the taps (both sources together)
  int c_split;  // channels [0, c_split) come from v0, the rest from v1
  int n0;       // windows [n0, ..) use the second tap set
};

__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// The 8 channels [ch, ch + 8) of the taps at pixel (b, y, x): acc = conv + bias.
template <typename TW>
__device__ __forceinline__ void conv8(const bf16* __restrict__ v0, size_t ps0,
                                      const bf16* __restrict__ v1, size_t ps1,
                                      const TW* __restrict__ w, const TW* __restrict__ bias,
                                      const Geom& g, int b, int y, int x, int ch,
                                      float acc[VEC]) {
  const bool first = ch < g.c_split;
  const bf16* v = first ? v0 : v1;
  const size_t ps = first ? ps0 : ps1;
  const int lch = first ? ch : ch - g.c_split;
  const int i = y % g.sp_h, j = x % g.sp_w;
#pragma unroll
  for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
  for (int di = -1; di <= 1; ++di) {
    if (i + di < 0 || i + di >= g.sp_h) continue;
    for (int dj = -1; dj <= 1; ++dj) {
      if (j + dj < 0 || j + dj >= g.sp_w) continue;
      const size_t p = (((size_t)b * g.H + y + di) * g.W + x + dj) * ps + lch;
      const uint4 raw = *reinterpret_cast<const uint4*>(v + p);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      const TW* wt = w + ((di + 1) * 3 + dj + 1) * g.c + ch;
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] += to_f(wt[t]) * bf2f(e[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < VEC; ++t) acc[t] += to_f(bias[ch + t]);
}

template <typename TW, bool FOLD>
__global__ void __launch_bounds__(THREADS)
lepe_windows_kernel(const bf16* __restrict__ v0, size_t ps0, const bf16* __restrict__ v1,
                    size_t ps1, const TW* __restrict__ w0, const TW* __restrict__ b0,
                    const TW* __restrict__ w1, const TW* __restrict__ b1,
                    bf16* __restrict__ out, Geom g, long long chunks) {
  const int c_out = FOLD ? g.c / 2 : g.c;
  const int per_px = c_out / VEC;
  const int n_wh = g.H / g.sp_h, n_ww = g.W / g.sp_w;
  for (long long idx = blockIdx.x * (long long)THREADS + threadIdx.x; idx < chunks;
       idx += (long long)gridDim.x * THREADS) {
    const long long px = idx / per_px;
    const int ch = (int)(idx % per_px) * VEC;
    const int x = (int)(px % g.W), y = (int)((px / g.W) % g.H);
    const int b = (int)(px / ((long long)g.W * g.H));
    const long long win = ((long long)b * n_wh + y / g.sp_h) * n_ww + x / g.sp_w;
    const bool second = win >= g.n0;
    const TW* w = second ? w1 : w0;
    const TW* bias = second ? b1 : b0;
    float acc[VEC];
    conv8<TW>(v0, ps0, v1, ps1, w, bias, g, b, y, x, ch, acc);
    if constexpr (FOLD) {
      float other[VEC];
      conv8<TW>(v0, ps0, v1, ps1, w, bias, g, b, y, x, ch + c_out, other);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] += other[t];
    }
    uint4 packed;
    bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int t = 0; t < VEC; ++t) e[t] = f2bf(acc[t]);
    *reinterpret_cast<uint4*>(out + px * c_out + ch) = packed;
  }
}

template <typename TW>
int launch(const bf16* v0, size_t ps0, const bf16* v1, size_t ps1, const void* w0,
           const void* b0, const void* w1, const void* b1, bf16* out, const Geom& g,
           int B, bool fold, cudaStream_t stream) {
  const int c_out = fold ? g.c / 2 : g.c;
  const long long chunks = (long long)B * g.H * g.W * (c_out / VEC);
  const long long ctas = (chunks + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)(ctas < 0x7fffffffLL ? ctas : 0x7fffffffLL));
  const TW *tw0 = (const TW*)w0, *tb0 = (const TW*)b0, *tw1 = (const TW*)w1,
           *tb1 = (const TW*)b1;
  if (fold)
    lepe_windows_kernel<TW, true><<<grid, THREADS, 0, stream>>>(v0, ps0, v1, ps1, tw0, tb0,
                                                               tw1, tb1, out, g, chunks);
  else
    lepe_windows_kernel<TW, false><<<grid, THREADS, 0, stream>>>(v0, ps0, v1, ps1, tw0, tb0,
                                                                tw1, tb1, out, g, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// v0: bf16, pixel (b, y, x) of the (B, H, W) batch at (b·H·W + y·W + x)·ps0,
// channels [0, c_split) contiguous there; v1 likewise for channels
// [c_split, c) with stride ps1 (null when c_split == c). w0, w1: (9, c)
// tap-major (tap = (di+1)·3 + dj+1), b0, b1: (c,), all float32 or all bf16
// (taps_bf16); windows (image-major, then window rows, then window columns)
// from n0 on use w1 and b1 (n0 >= the window count: never). out: contiguous
// (B, H, W, c), or (B, H, W, c/2) with fold. Requires H % sp_h == W % sp_w == 0,
// c, c_split and with fold c/2 multiples of 8, both strides multiples of 8
// and 16-byte aligned v0, v1 and out (checked by the wrapper).
CSWIN_API int cswin_lepe_windows(const void* v0, long long ps0, const void* v1,
                                 long long ps1, int c_split, const void* w0,
                                 const void* b0, const void* w1, const void* b1,
                                 int taps_bf16, void* out, int B, int H, int W, int c,
                                 int sp_h, int sp_w, int n0, int fold, void* stream) {
  if (sp_h < 1 || sp_w < 1 || H % sp_h || W % sp_w || c % VEC || c_split % VEC ||
      c_split < 0 || c_split > c || (c_split < c && v1 == nullptr) ||
      (fold && (c / 2) % VEC))
    return (int)cudaErrorInvalidValue;
  const Geom g{H, W, sp_h, sp_w, c, c_split, n0};
  const cudaStream_t s = (cudaStream_t)stream;
  if (taps_bf16)
    return launch<bf16>((const bf16*)v0, (size_t)ps0, (const bf16*)v1, (size_t)ps1, w0, b0,
                        w1, b1, (bf16*)out, g, B, fold != 0, s);
  return launch<float>((const bf16*)v0, (size_t)ps0, (const bf16*)v1, (size_t)ps1, w0, b0,
                       w1, b1, (bf16*)out, g, B, fold != 0, s);
}
