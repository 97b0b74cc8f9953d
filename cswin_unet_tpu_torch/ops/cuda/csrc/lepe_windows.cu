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
// Design: persistent CTAs, one wave sized by the occupancy API (four CTAs
//   of 128 threads an SM), walk tiles cta, cta + grid, ...; a tile is
//   `group` whole windows times a block of `nb` output chunks of 8 channels
//   (with fold, the chunks of both halves), about 14 KB, so no halo crosses
//   a window edge and no pixel is read twice. A ring of two tiles in shared
//   memory is filled with 16-byte cp.async copies: the next tile's copies
//   are in flight while this tile's sums run. Two threads share a staged
//   chunk, four channels each (a thread of 8 channels takes 202 registers,
//   two CTAs an SM, and runs 5% slower on an H100); a thread's share is fixed for the tile, and it keeps that share's 9 x 4
//   taps and 4 biases in float32 registers, reloaded only when the channels
//   or the tap set change. It walks SEG outputs along a window row with the
//   3x3 neighbourhood in registers: each step reads the next column's three
//   8-byte vectors from shared memory (the rows outside the window skipped,
//   as the taps are) and writes 8 bytes, the two threads of a chunk 16
//   adjacent ones. With fold the two threads of a pair of chunks add their
//   sums through a shuffle and the lower one stores. The divisions of the
//   address arithmetic are multiplies by constants fixed per launch (Div).
//   The sum order per output is the one-thread-a-pixel kernel's before it:
//   zero, then the taps di outer and dj inner, each acc += w·v (an FMA), a
//   neighbour beyond the window's side read as zero (w·0 adds exactly
//   nothing to a sum that is never −0), then the bias, then with fold the
//   other half's result: the same bits.

#include "common.cuh"
#include "persistent.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int VEC = 8;                 // bf16 values per 16-byte copy: a chunk
constexpr int CH = 4;                  // channels a thread: half a chunk, 8 bytes
constexpr int PARTS = VEC / CH;        // threads a staged chunk
constexpr int SEG = 7;                 // outputs a thread walks along a window row
constexpr int STAGES = 2;              // tiles in the ring
constexpr int MAX_NB = 16;             // output chunks of a channel block
constexpr int TILE_BYTES = 14 * 1024;  // a staged tile's target size

using Vec = uint2;  // a thread's CH bf16 values: one shared-memory read, one store
static_assert(sizeof(Vec) == 2 * CH, "a thread's share of a chunk");

__device__ __forceinline__ void unpack(const uint2& u, float (&f)[4]) {
  const float2 lo = unpack_bf16(u.x), hi = unpack_bf16(u.y);
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}
__device__ __forceinline__ void pack(const float (&f)[4], uint2& u) {
  u = make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// n / d for 0 <= n < 2^31 as (umulhi(n, m) + n) >> l, with l = ceil(log2 d)
// and m = floor(2^32 (2^l - d) / d) + 1 (Granlund and Montgomery's
// round-down form; mirrored by kernels.py::div_magic).
struct Div {
  int d;
  unsigned m;
  int l;
};

Div make_div(int d) {
  Div r{d, 0u, 0};
  while ((1LL << r.l) < d) ++r.l;
  r.m = (unsigned)(((((1ULL << r.l) - (unsigned long long)d)) << 32) / (unsigned long long)d + 1);
  return r;
}

__device__ __forceinline__ int quot(const Div& v, int n) {
  return (int)((__umulhi((unsigned)n, v.m) + (unsigned)n) >> v.l);
}

struct Plan {
  int nb;        // output chunks of a channel block
  int slots;     // staged chunks a pixel: nb, or both halves' 2·nb with fold
  int blocks;    // channel blocks
  int group;     // windows a tile
  int tiles;     // (window group, channel block) pairs, channel block fastest
  int smem;      // bytes of the ring
  int ctas_per_sm, grid;
};

// The tile plan of kernels.py::lepe_windows_plan, without the grid; false
// where one window of one chunk pair does not fit the ring.
bool make_plan(int windows, int px, int c, bool fold, Plan& p) {
  const int out_chunks = (fold ? c / 2 : c) / VEC;
  // a pixel's threads (slots x PARTS) within a warp: the fold's shuffles
  const int max_nb = MAX_NB < 32 / (PARTS * (fold ? 2 : 1)) ? MAX_NB : 32 / (PARTS * (fold ? 2 : 1));
  int nb = 1;
  while (nb * 2 <= max_nb && out_chunks % (nb * 2) == 0) nb *= 2;
  const auto win_bytes = [&](int b) { return (long long)px * (fold ? 2 * b : b) * 16; };
  while (nb > 1 && win_bytes(nb) > TILE_BYTES) nb /= 2;
  if (STAGES * win_bytes(nb) > persistent::SMEM_MAX || windows < 1) return false;
  p.nb = nb;
  p.slots = fold ? 2 * nb : nb;
  p.blocks = out_chunks / nb;
  const long long fit = TILE_BYTES / win_bytes(nb);
  p.group = (int)(fit < 1 ? 1 : fit < windows ? fit : windows);
  const long long tiles = (long long)((windows + p.group - 1) / p.group) * p.blocks;
  if (tiles > 0x7fffffffLL) return false;
  p.tiles = (int)tiles;
  p.smem = (int)(STAGES * p.group * win_bytes(nb));
  return true;
}

struct Args {
  const bf16* v0;
  const bf16* v1;
  long long ps0, ps1;
  const void* w0;
  const void* b0;
  const void* w1;
  const void* b1;
  bf16* out;
  int H, W, sp_h, sp_w, c, c_split, n0, windows, c_out;
  int half;     // with fold, the first chunk of the second half
  int per_img;  // windows an image
  int nww;      // windows a window row
  int nb, slots, blocks, group, tiles, nseg;
  Div d_blocks, d_slots, d_lanes, d_px, d_spw, d_sph, d_nseg, d_per_img, d_nww;
};

__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// The input chunk (8 channels) that slot s of channel block kb stages.
__device__ __forceinline__ int slot_chunk(const Args& a, int s, int kb) {
  return s >= a.nb ? a.half + kb * a.nb + (s - a.nb) : kb * a.nb + s;
}

// The first pixel of window `win` as an index into the (B, H, W) batch.
__device__ __forceinline__ long long window_origin(const Args& a, int win) {
  const int b = quot(a.d_per_img, win), r = win - b * a.per_img;
  const int wy = quot(a.d_nww, r), wx = r - wy * a.nww;
  return ((long long)b * a.H + wy * a.sp_h) * a.W + wx * a.sp_w;
}

// Tile t's chunks into ring stage dst, laid out [window][pixel][slot].
__device__ __forceinline__ void issue(const Args& a, uint4* dst, int t) {
  const int wg = quot(a.d_blocks, t), kb = t - wg * a.blocks;
  const int w_first = wg * a.group, px = a.sp_h * a.sp_w;
  const int slot = threadIdx.x % a.slots;  // THREADS % slots == 0: fixed over i
  const int ch = slot_chunk(a, slot, kb) * VEC;
  const bool first = ch < a.c_split;
  const bf16* src = first ? a.v0 + ch : a.v1 + (ch - a.c_split);
  const long long ps = first ? a.ps0 : a.ps1;
  const int wins = min(a.group, a.windows - w_first);
  const int n = wins * px * a.slots;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int q = quot(a.d_slots, i);
    const int g = quot(a.d_px, q), p = q - g * px;
    const int y = quot(a.d_spw, p), x = p - y * a.sp_w;
    const long long pix = window_origin(a, w_first + g) + (long long)y * a.W + x;
    cp_async16(dst + i, src + pix * ps);
  }
}

// A column of the neighbourhood: rows y-1, y, y+1 at window column x (zero
// beyond the window's side; the rows outside the window are not read). row:
// the thread's share of column 0 of row y; rs a row, cs a column, in Vecs.
__device__ __forceinline__ void load_col(const Vec* row, int rs, int cs, int x, int sp_w,
                                         bool up, bool down, float (&col)[3][CH]) {
  const bool in = x >= 0 && x < sp_w;
  const Vec zero{};
  const Vec* p = row + x * cs;
  if (up) unpack(in ? p[-rs] : zero, col[0]);
  unpack(in ? p[0] : zero, col[1]);
  if (down) unpack(in ? p[rs] : zero, col[2]);
}

// One row of taps (dj = -1, 0, 1 in turn) into the thread's sums.
__device__ __forceinline__ void taps_row(float (&acc)[CH], const float (&wl)[CH],
                                         const float (&wc)[CH], const float (&wr)[CH],
                                         const float (&vl)[CH], const float (&vc)[CH],
                                         const float (&vr)[CH]) {
#pragma unroll
  for (int t = 0; t < CH; ++t) {
    acc[t] = fmaf(wl[t], vl[t], acc[t]);
    acc[t] = fmaf(wc[t], vc[t], acc[t]);
    acc[t] = fmaf(wr[t], vr[t], acc[t]);
  }
}

// The taps and biases of channels [ch, ch + CH).
template <typename TW>
__device__ __forceinline__ void load_taps(const Args& a, int ch, bool second,
                                          float (&tw)[9][CH], float (&tb)[CH]) {
  const TW* w = reinterpret_cast<const TW*>(second ? a.w1 : a.w0) + ch;
  const TW* b = reinterpret_cast<const TW*>(second ? a.b1 : a.b0) + ch;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int t = 0; t < CH; ++t) tw[tap][t] = to_f(__ldg(w + tap * a.c + t));
#pragma unroll
  for (int t = 0; t < CH; ++t) tb[t] = to_f(__ldg(b + t));
}

template <typename TW, bool FOLD>
__global__ void __launch_bounds__(THREADS, 4)
lepe_windows_kernel(const Args a) {
  extern __shared__ uint4 ring[];
  const int px = a.sp_h * a.sp_w, stage = a.group * px * a.slots;
  const int lanes = a.slots * PARTS;  // threads a pixel
  const int slot = threadIdx.x % lanes / PARTS, part = threadIdx.x % PARTS;
  const int rs = a.sp_w * lanes;      // a window row, in Vecs
  const int items = a.group * a.sp_h * a.nseg * lanes;
  float tw[9][CH], tb[CH];
  int loaded = -1;  // (channel << 1) | tap set of the taps in registers

  const int first = blockIdx.x, step = gridDim.x;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {  // the ring's first tiles
    if (first + k * step < a.tiles) issue(a, ring + k * stage, first + k * step);
    cp_async_commit();
  }
  int t = first;
  for (int i = 0; t < a.tiles; ++i, t += step) {
    const Vec* cur = reinterpret_cast<const Vec*>(ring + (i % STAGES) * stage);
    const int ahead = t + (STAGES - 1) * step;
    if (ahead < a.tiles) issue(a, ring + ((i + STAGES - 1) % STAGES) * stage, ahead);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    const int wg = quot(a.d_blocks, t), kb = t - wg * a.blocks;
    const int ch = slot_chunk(a, slot, kb) * VEC + part * CH;
    // Every lane runs every step (the fold's shuffles): an item past the
    // tile reads window 0 and stores nothing.
    for (int base = 0; base < items; base += THREADS) {
      const int it = base + threadIdx.x;
      const int r = quot(a.d_lanes, it < items ? it : 0);  // (window, row, segment)
      const int gy = quot(a.d_nseg, r), seg = r - gy * a.nseg;
      const int g = quot(a.d_sph, gy), y = gy - g * a.sp_h;
      const int win = wg * a.group + g;
      const bool live = it < items && win < a.windows;
      const int key = ch * 2 + (win >= a.n0);
      if (key != loaded) {
        load_taps<TW>(a, ch, win >= a.n0, tw, tb);
        loaded = key;
      }
      const Vec* row = cur + (g * a.sp_h + y) * rs + slot * PARTS + part;
      const bool up = y > 0, down = y + 1 < a.sp_h;
      const int x0 = seg * SEG;
      bf16* o = a.out + (window_origin(a, live ? win : 0) + (long long)y * a.W + x0) * a.c_out + ch;
      float col[3][3][CH];  // columns x-1, x, x+1 at slots k, k+1, k+2 (mod 3)
      load_col(row, rs, lanes, x0 - 1, a.sp_w, up, down, col[0]);
      load_col(row, rs, lanes, x0, a.sp_w, up, down, col[1]);
#pragma unroll
      for (int k = 0; k < SEG; ++k) {
        const int x = x0 + k;
        float(&l)[3][CH] = col[k % 3];
        float(&m)[3][CH] = col[(k + 1) % 3];
        float(&rr)[3][CH] = col[(k + 2) % 3];
        load_col(row, rs, lanes, x + 1, a.sp_w, up, down, rr);
        float acc[CH];
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[e] = 0.f;
        if (up) taps_row(acc, tw[0], tw[1], tw[2], l[0], m[0], rr[0]);
        taps_row(acc, tw[3], tw[4], tw[5], l[1], m[1], rr[1]);
        if (down) taps_row(acc, tw[6], tw[7], tw[8], l[2], m[2], rr[2]);
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[e] += tb[e];
        if constexpr (FOLD) {
#pragma unroll
          for (int e = 0; e < CH; ++e)
            acc[e] += __shfl_down_sync(0xffffffffu, acc[e], a.nb * PARTS);
        }
        if (live && x < a.sp_w && (!FOLD || slot < a.nb)) {
          Vec v;
          pack(acc, v);
          *reinterpret_cast<Vec*>(o + (long long)k * a.c_out) = v;
        }
      }
    }
    __syncthreads();  // the stage is refilled STAGES - 1 tiles on
  }
  cp_async_wait<0>();
}

template <typename TW, bool FOLD>
cudaError_t occupancy(const Plan& p, int& ctas, int& sms) {
  return persistent::occupancy(lepe_windows_kernel<TW, FOLD>, THREADS, p.smem, ctas, sms);
}

// The plan of a launch, its grid one wave from the occupancy API; an error
// where the geometry is refused.
cudaError_t plan_for(int B, int H, int W, int c, int c_split, int sp_h, int sp_w, int fold,
                     int taps_bf16, Plan& p) {
  if (B < 1 || sp_h < 1 || sp_w < 1 || H % sp_h || W % sp_w || c < VEC || c % VEC ||
      c_split % VEC ||
      c_split < 0 || c_split > c || (fold && (c / 2) % VEC) ||
      (long long)B * H * W > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int windows = B * (H / sp_h) * (W / sp_w);
  if (!make_plan(windows, sp_h * sp_w, c, fold != 0, p)) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e =
      taps_bf16 ? (fold ? occupancy<bf16, true>(p, p.ctas_per_sm, sms)
                        : occupancy<bf16, false>(p, p.ctas_per_sm, sms))
                : (fold ? occupancy<float, true>(p, p.ctas_per_sm, sms)
                        : occupancy<float, false>(p, p.ctas_per_sm, sms));
  if (e != cudaSuccess) return e;
  const long long wave = (long long)p.ctas_per_sm * sms;
  p.grid = (int)(p.tiles < wave ? p.tiles : wave);
  return cudaSuccess;
}

}  // namespace

// v0: bf16, pixel (b, y, x) of the (B, H, W) batch at (b·H·W + y·W + x)·ps0,
// channels [0, c_split) contiguous there; v1 likewise for channels
// [c_split, c) with stride ps1 (null when c_split == c). w0, w1: (9, c)
// tap-major (tap = (di+1)·3 + dj+1), b0, b1: (c,), all float32 or all bf16
// (taps_bf16); windows (image-major, then window rows, then window columns)
// from n0 on use w1 and b1 (n0 >= the window count: never). out: contiguous
// (B, H, W, c), or (B, H, W, c/2) with fold. Requires H % sp_h == W % sp_w == 0,
// c, c_split and with fold c/2 multiples of 8, both strides multiples of 8,
// 16-byte aligned v0, v1 and out (checked by the wrapper), and two tiles of
// one window's chunks within 227 KB (kernels.py::lepe_windows_plan).
CSWIN_API int cswin_lepe_windows(const void* v0, long long ps0, const void* v1,
                                 long long ps1, int c_split, const void* w0,
                                 const void* b0, const void* w1, const void* b1,
                                 int taps_bf16, void* out, int B, int H, int W, int c,
                                 int sp_h, int sp_w, int n0, int fold, void* stream) {
  if (c_split < c && v1 == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = plan_for(B, H, W, c, c_split, sp_h, sp_w, fold, taps_bf16, p);
  if (e != cudaSuccess) return (int)e;
  Args a{(const bf16*)v0, (const bf16*)v1, ps0, ps1, w0, b0, w1, b1, (bf16*)out};
  a.H = H;
  a.W = W;
  a.sp_h = sp_h;
  a.sp_w = sp_w;
  a.c = c;
  a.c_split = c_split;
  a.n0 = n0;
  a.windows = B * (H / sp_h) * (W / sp_w);
  a.c_out = fold ? c / 2 : c;
  a.half = fold ? c / 2 / VEC : 0;
  a.nb = p.nb;
  a.slots = p.slots;
  a.blocks = p.blocks;
  a.group = p.group;
  a.tiles = p.tiles;
  a.nseg = (sp_w + SEG - 1) / SEG;
  a.d_blocks = make_div(p.blocks);
  a.d_slots = make_div(p.slots);
  a.d_lanes = make_div(p.slots * PARTS);
  a.d_px = make_div(sp_h * sp_w);
  a.d_spw = make_div(sp_w);
  a.d_sph = make_div(sp_h);
  a.d_nseg = make_div(a.nseg);
  a.per_img = (H / sp_h) * (W / sp_w);
  a.nww = W / sp_w;
  a.d_per_img = make_div(a.per_img);
  a.d_nww = make_div(a.nww);
  const cudaStream_t s = (cudaStream_t)stream;
  if (taps_bf16) {
    if (fold) lepe_windows_kernel<bf16, true><<<p.grid, THREADS, p.smem, s>>>(a);
    else lepe_windows_kernel<bf16, false><<<p.grid, THREADS, p.smem, s>>>(a);
  } else {
    if (fold) lepe_windows_kernel<float, true><<<p.grid, THREADS, p.smem, s>>>(a);
    else lepe_windows_kernel<float, false><<<p.grid, THREADS, p.smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The plan a launch of this geometry takes (mirrored by
// kernels.py::lepe_windows_plan): info[0..7] = output chunks a channel
// block, staged chunks a pixel, channel blocks, windows a tile, tiles,
// shared bytes, CTAs an SM, grid. Returns the entry's refusal, if any.
CSWIN_API int cswin_lepe_windows_plan(int B, int H, int W, int c, int sp_h, int sp_w,
                                      int fold, int taps_bf16, int* info) {
  Plan p;
  const cudaError_t e = plan_for(B, H, W, c, c, sp_h, sp_w, fold, taps_bf16, p);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {p.nb, p.slots, p.blocks, p.group, p.tiles, p.smem, p.ctas_per_sm, p.grid};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return 0;
}
