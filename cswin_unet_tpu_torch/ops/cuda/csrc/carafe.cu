// CARAFE kernel prediction + reassembly, after the (down | classes) GEMM.
// The bf16 kernel below; its float32 instance (cswin_carafe_f32) serves
// TPU.COMPUTE_DTYPE float32.
//
// Input `gy` is the GEMM output (B, H, W, G) bf16, G >= cm + nc, G and cm
// multiples of 8 (carafe_fused pads G; every config's cm = C/4 is): channels
// [0, cm) are the 1x1 down conv `mid` (bias added), channels [cm, cm + nc)
// are y = x·W_y (no bias), where W_y is the 1x1 out conv, or for the
// model's tail the out conv folded with the classifier (W_out·W_cls);
// channels past cm + nc (the GEMM's zero padding to a multiple of 8) are
// never read into an output. For each low-res pixel and up-position s:
//   enc[t]  = b_enc[t·up² + s] + Σ_{3x3, ci} mid[nbr] · W_enc[.., ci, t·up² + s]
//   k[t]    = bf16(softmax_t(enc))                         (float32 softmax)
//   out[n]  = Σ_t k[t] · y[pixel + tap t][n] + bias[n]    (float32)
// and writes either bf16 logits at the depth-to-space position
// (h·up + i, w·up + j), s = i·up + j, or int32 labels (first max wins).
// Zero padding at the image border, for the encoder conv and the taps.
//
// Replaces: cswin_unet_tpu/ops/pallas/carafe_tail.py::_kernel (called by
//   carafe_fused_pallas for carafe_up, carafe_tail and
//   carafe_tail_argmax_pallas).
// Bound on the H100: bytes — gy read once (cm + nc bf16 a low-res pixel)
//   and the high-res output written once (nc bf16 or one int32 a pixel);
//   the 3x3 encoder conv (81·cm·up² MACs a low-res pixel) is bf16 products,
//   and the reassembly 9·nc·up² float32 FMAs a low-res pixel.
// Design: persistent CTAs (one wave, from the occupancy API) of 4 warps
//   loop over 8x8 tiles of low-res pixels. A CTA stages the encoder weight
//   once with cp.async, in the order the lanes want its columns, laid out
//   for ldmatrix; each tile's mid and y with a one-pixel halo arrive by
//   16-byte cp.async into a double buffer, the next tile's during this
//   one's work. The encoder conv is an
//   implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//   out: the products of two bf16 values are exact, only the sum order
//   moves): a warp takes 16 pixels (two tile rows), its A rows are the
//   halo pixels under each tap, read straight from shared memory by
//   ldmatrix, against all 9·up² encoder columns. The columns are permuted
//   so that each lane's accumulators hold all 9 taps of its own
//   up-positions: the softmax runs in float32 in registers, with no
//   shuffles, and rounds k to bf16 as the reference does. The reassembly
//   runs on the CUDA cores from the halo's y, 8 classes at a time (the
//   four lanes of a pixel share its classes at up = 2); the results go to
//   a per-warp stage in shared memory laid out as the tile's high-res rows,
//   which leave as 16-byte segments (the depth-to-space happens in the
//   stage's addresses).
// Measured (NVIDIA H100 80GB HBM3, 700 W, B = 32): the tail's softmax and
//   reassembly take most of its time, and neither more CTAs an SM nor
//   8-warp CTAs helped; by a count of their instructions the exponentials,
//   the bf16 conversions, the FMAs and the B fragments' ldmatrix are what
//   an SM has to issue.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TW = 8, TH = 8, HWD = TW + 2, HALO_PX = (TH + 2) * HWD;
constexpr int WARPS = TH / 2, THREADS = WARPS * 32;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The encoder's output columns as the implicit GEMM orders them. A lane
// (g, q) of the mma's accumulator tile holds columns 8j + 2q + e of every
// n8 tile j (e = 0, 1); it owns up-positions q·P .. q·P + P - 1 (P = up²/4)
// and the pair u = 2j + e is its tap u / P at position q·P + u % P. U pairs
// (rounded to even), NT n8 tiles, NT2 of them staged (ldmatrix loads two).
template <int UP>
struct Enc {
  static constexpr int UP2 = UP * UP, P = UP2 / 4, ENC = 9 * UP2;
  static constexpr int U = round_up(9 * P, 2), NT = U / 2, NT2 = round_up(NT, 2);
  static_assert(UP2 % 4 == 0, "four lanes share a pixel's up-positions");

  // The GEMM column of encoder output channel o = tap·up² + s.
  __device__ static int column(int o) {
    const int t = o / UP2, s = o % UP2, u = t * P + s % P;
    return 8 * (u >> 1) + 2 * (s / P) + (u & 1);
  }
};

// Shared memory of one CTA, in bytes: the encoder weight (NT2·8 rows of
// Ks bf16: 9 taps of cmp channels, cmp = cm rounded up to 16, zero past
// cm), two halo tiles (HALO_PX pixels of Gs bf16, gy's G channels), a
// stage per warp, the encoder bias and the bias. Row strides are odd
// multiples of 16 bytes, so ldmatrix's eight rows fall in distinct banks.
struct Layout {
  int cmp, Gs, Ks, stage;
  int w_off, halo_off, stage_off, benc_off, bias_off, total;
};

template <int UP>
__host__ __device__ Layout make_layout(int cm, int nc, int G, bool labels) {
  using E = Enc<UP>;
  Layout L;
  L.cmp = round_up(cm, 16);
  L.Gs = G / 8 % 2 ? G + 16 : G + 8;
  L.Ks = 9 * L.cmp + 8;
  L.stage = round_up(2 * UP * TW * UP * (labels ? 4 : 2 * nc), 16);
  L.w_off = 0;
  L.halo_off = L.w_off + E::NT2 * 8 * L.Ks * 2;
  L.stage_off = L.halo_off + 2 * HALO_PX * L.Gs * 2;
  L.benc_off = L.stage_off + WARPS * L.stage;
  L.bias_off = L.benc_off + round_up(E::ENC * 4, 16);
  L.total = L.bias_off + round_up(nc * 4, 16);
  return L;
}

// At most 168 registers a thread, so that 3 CTAs fit an SM where shared
// memory allows it (the tail's labels); no instance spills there.
template <int UP, bool LABELS>
__global__ void __launch_bounds__(THREADS, 3)
carafe_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ wenc,
              const float* __restrict__ benc, const float* __restrict__ bias,
              void* __restrict__ out, int B, int H, int W, int G, int cm, int nc) {
  using E = Enc<UP>;
  constexpr int UP2 = E::UP2, P = E::P, NT = E::NT, NT2 = E::NT2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout<UP>(cm, nc, G, LABELS);
  bf16* Ws = reinterpret_cast<bf16*>(smem + L.w_off);
  float* benc_s = reinterpret_cast<float*>(smem + L.benc_off);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int TX = (W + TW - 1) / TW, TY = (H + TH - 1) / TH, tiles = B * TX * TY;

  // The encoder weight, once a CTA: zeros first (padded channels, padded
  // columns), then each output channel's 9·cm values into its GEMM column.
  for (int i = tid; i < E::NT2 * 8 * L.Ks / 8; i += THREADS)
    reinterpret_cast<uint4*>(Ws)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < E::ENC; i += THREADS) benc_s[i] = benc[i];
  for (int i = tid; i < nc; i += THREADS) bias_s[i] = bias[i];
  __syncthreads();
  for (int i = tid; i < E::ENC * 9; i += THREADS) {  // (output channel, tap): cm values
    bf16* dst = Ws + E::column(i / 9) * L.Ks + i % 9 * L.cmp;
    const bf16* src = wenc + (size_t)i * cm;
    for (int c = 0; c < cm; c += 8) cp_async16(dst + c, src + c);
  }

  const auto halo = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + L.halo_off) + buf * HALO_PX * L.Gs;
  };
  // The halo tile of `tile` into buffer `buf`; zeros outside the image.
  const auto load_halo = [&](int tile, int buf) {
    bf16* hs = halo(buf);
    const int b = tile / (TX * TY), ty = tile / TX % TY, tx = tile % TX;
    const int r0 = ty * TH - 1, c0 = tx * TW - 1, chunks = G / 8;
    for (int i = tid; i < HALO_PX * chunks; i += THREADS) {
      const int p = i / chunks, c = i % chunks * 8;
      const int y = r0 + p / HWD, x = c0 + p % HWD;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      cp_async16(hs + p * L.Gs + c, ok ? gy + (((size_t)b * H + y) * W + x) * G + c : gy,
                 ok ? 16 : 0);
    }
  };

  const int HU = H * UP, WU = W * UP;
  const int elem = LABELS ? 4 : 2 * nc;  // bytes of a high-res pixel
  unsigned char* stage = smem + L.stage_off + warp * L.stage;
  const int lr0 = 2 * warp;  // this warp's first tile row
  // A rows: m = lane % 16 is pixel (lr0 + m / 8, m % 8); lanes 16-31 give
  // the second eight channels of the k16 step. B rows as gemm_tile's.
  const int m = lane & 15;
  const int a_px = (lr0 + (m >> 3)) * HWD + (m & 7);
  const bf16* b_row = Ws + ((lane >> 4) * 8 + (lane & 7)) * L.Ks + ((lane >> 3) & 1) * 8;

  load_halo(blockIdx.x, 0);
  cp_async_commit();
  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    if (tile + (int)gridDim.x < tiles) load_halo(tile + gridDim.x, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's halo (and, first, the weight) landed
    __syncthreads();
    const bf16* hs = halo(it & 1);
    const int b = tile / (TX * TY), y0 = tile / TX % TY * TH, x0 = tile % TX * TW;
    if (y0 + lr0 < H) {  // warp-uniform
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const bf16* a_row = hs + a_px * L.Gs + (lane >> 4) * 8;
      for (int t = 0; t < 9; ++t) {
        const bf16* at = a_row + ((t / 3) * HWD + t % 3) * L.Gs;
        const bf16* bt = b_row + t * L.cmp;
        for (int c0 = 0; c0 < L.cmp; c0 += 16) {
          uint32_t a[4];
          ldsm_x4(a, at + c0);
#pragma unroll
          for (int jp = 0; jp < NT2 / 2; ++jp) {
            uint32_t r[4];
            ldsm_x4(r, bt + jp * 16 * L.Ks + c0);
            mma_bf16(acc[2 * jp], a, r[0], r[1]);
            if (2 * jp + 1 < NT) mma_bf16(acc[2 * jp + 1], a, r[2], r[3]);
          }
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {  // pixel (lr0 + h, g) of the tile
        // The softmax over the taps of this lane's own up-positions
        // q·P + sl: float32, the exponentials by ex2.approx and one
        // division a position (their ~2^-21 relative error is far below
        // the bf16 rounding of k that follows).
        float k[P][9];
#pragma unroll
        for (int sl = 0; sl < P; ++sl) {
          float e[9];
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int u = t * P + sl;
            e[t] = acc[u >> 1][2 * h + (u & 1)] + benc_s[t * UP2 + q * P + sl];
          }
          float mx = e[0];
#pragma unroll
          for (int t = 1; t < 9; ++t) mx = fmaxf(mx, e[t]);
          float sum = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            e[t] = __expf(e[t] - mx);
            sum += e[t];
          }
          const float inv = 1.f / sum;
#pragma unroll
          for (int t = 0; t < 9; ++t) k[sl][t] = round_bf16(e[t] * inv);
        }
        // Each lane reassembles four up-positions, slot i at position
        // s_of(i). At up = 4 they are its own (P = 4) and it takes every
        // class; at up = 2 it gathers the other three lanes' weights of its
        // pixel and takes every fourth block of 8 classes (and of the
        // 2-class words past the last whole block), so that the four
        // lanes of a pixel unpack each y value once between them.
        float k4[4][9];
        if constexpr (P == 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int t = 0; t < 9; ++t) k4[i][t] = k[i][t];
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int t = 0; t < 9; ++t)
              k4[i][t] = __shfl_sync(0xffffffffu, k[0][t], (lane & ~3) | i);
        }
        const auto s_of = [&](int i) { return P == 4 ? q * 4 + i : i; };
        const int first = P == 4 ? 0 : q, stride = P == 4 ? 1 : 4;
        const bf16* yb = hs + ((lr0 + h) * HWD + g) * L.Gs + cm;
        float best[4];
        int arg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          best[i] = -INFINITY;
          arg[i] = 0;
        }
        // Classes [n0, n0 + WD) for the four slots: WD = 8 (one 16-byte
        // load a tap) or 2 (one bf16x2 word), in class order.
        const auto classes = [&](auto width, int n0) {
          constexpr int WD = decltype(width)::value;
          float o[4][WD];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < WD; ++e) o[i][e] = 0.f;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const bf16* yp = yb + ((t / 3) * HWD + t % 3) * L.Gs + n0;
            float yv[WD];
            if constexpr (WD == 8) {
              unpack8(*reinterpret_cast<const uint4*>(yp), yv);
            } else {
              const float2 v = unpack_bf16(*reinterpret_cast<const uint32_t*>(yp));
              yv[0] = v.x;
              yv[1] = v.y;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < WD; ++e) o[i][e] += k4[i][t] * yv[e];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = s_of(i);
            const int px = (h * UP + s / UP) * TW * UP + g * UP + s % UP;  // in the stage
#pragma unroll
            for (int e = 0; e < WD; ++e) o[i][e] += n0 + e < nc ? bias_s[n0 + e] : 0.f;
            if constexpr (LABELS) {
#pragma unroll
              for (int e = 0; e < WD; ++e)
                if (n0 + e < nc && o[i][e] > best[i]) {
                  best[i] = o[i][e];
                  arg[i] = n0 + e;
                }
            } else {
              bf16* dst = reinterpret_cast<bf16*>(stage) + (size_t)px * nc + n0;
              if (WD == 8 && nc % 8 == 0) {
                *reinterpret_cast<uint4*>(dst) =
                    make_uint4(pack_bf16(o[i][0], o[i][1]), pack_bf16(o[i][2], o[i][3]),
                               pack_bf16(o[i][4], o[i][5]), pack_bf16(o[i][6], o[i][7]));
              } else {
#pragma unroll
                for (int e = 0; e < WD; ++e)
                  if (n0 + e < nc) dst[e] = f2bf(o[i][e]);
              }
            }
          }
        };
        const int whole = nc / 8;
        for (int c = first; c < whole; c += stride)
          classes(std::integral_constant<int, 8>{}, 8 * c);
        for (int c = 8 * whole / 2 + first; 2 * c < nc; c += stride)
          classes(std::integral_constant<int, 2>{}, 2 * c);
        if constexpr (LABELS) {
          if constexpr (P == 1) {  // the four lanes' classes: the larger wins, a tie the first
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int o = 1; o < 4; o <<= 1) {
                const float b2 = __shfl_xor_sync(0xffffffffu, best[i], o);
                const int a2 = __shfl_xor_sync(0xffffffffu, arg[i], o);
                if (b2 > best[i] || (b2 == best[i] && a2 < arg[i])) {
                  best[i] = b2;
                  arg[i] = a2;
                }
              }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = s_of(i);
            if (P == 4 || i == q)
              reinterpret_cast<int*>(stage)[(h * UP + s / UP) * TW * UP + g * UP + s % UP] =
                  arg[i];
          }
        }
      }
      __syncwarp();

      // The warp's high-res rows, each vw·up pixels long, to global memory.
      const int vw = min(TW, W - x0), rows = min(2, H - y0 - lr0) * UP;
      const int seg = vw * UP * elem, stage_row = TW * UP * elem;
      const size_t first_px = ((size_t)b * HU + (size_t)(y0 + lr0) * UP) * WU + (size_t)x0 * UP;
      unsigned char* dst0 = reinterpret_cast<unsigned char*>(out) + first_px * elem;
      const size_t row_bytes = (size_t)WU * elem;
      if (seg % 16 == 0 && row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(dst0) & 15) == 0) {
        const int units = seg / 16;
        for (int i = lane; i < rows * units; i += 32) {
          const int rr = i / units, c = i % units * 16;
          *reinterpret_cast<uint4*>(dst0 + rr * row_bytes + c) =
              *reinterpret_cast<const uint4*>(stage + rr * stage_row + c);
        }
      } else {
        const int w = LABELS ? 4 : 2, units = seg / w;
        for (int i = lane; i < rows * units; i += 32) {
          const int rr = i / units, c = i % units * w;
          if constexpr (LABELS)
            *reinterpret_cast<int*>(dst0 + rr * row_bytes + c) =
                *reinterpret_cast<const int*>(stage + rr * stage_row + c);
          else
            *reinterpret_cast<bf16*>(dst0 + rr * row_bytes + c) =
                *reinterpret_cast<const bf16*>(stage + rr * stage_row + c);
        }
      }
      __syncwarp();  // the stage is written again for the next tile
    }
    __syncthreads();  // every warp is done with this halo buffer
  }
  cp_async_wait<0>();
}

template <int UP, bool LABELS>
cudaError_t launch(const bf16* gy, const bf16* wenc, const float* benc, const float* bias,
                   void* out, int B, int H, int W, int G, int cm, int nc,
                   cudaStream_t stream) {
  const Layout L = make_layout<UP>(cm, nc, G, LABELS);
  const auto kernel = carafe_kernel<UP, LABELS>;
  cudaError_t err = allow_smem(kernel, L.total);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, L.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;  // the weight and tiles exceed shared memory
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, THREADS, L.total, stream>>>(gy, wenc, benc, bias, out, B, H, W, G, cm, nc);
  return cudaGetLastError();
}

// --- the float32 instances (TPU.COMPUTE_DTYPE float32) ---------------------
//
// The same function from a float32 gy, nothing rounded: the encoder conv,
// the softmax (expf, one division a tap) and the reassembly in float32, the
// logits written as float32 (or the labels, first maximum wins). The products
// are FFMA on the CUDA cores (the bf16 kernel's tensor-core conv would round
// the operands). Each output keeps one order of operations: the encoder
// bias, then tap-major over ci by fmaf; the softmax; the reassembly over the
// 9 taps in order by fmaf, plus the bias.
// Design: persistent CTAs of 128 threads loop over 8x8 tiles of low-res
//   pixels. A thread takes one up-position s (the lane's fastest index) and
//   PX consecutive pixels of a tile row (up 4: the whole row of 8; up 2: 2)
//   and holds the 9 tap accumulators of each: a 16-byte word of the weight
//   read from shared memory feeds PX·4 FMAs and one of mid 9·4 (up 4: ~4.2
//   FMAs a float read). Sliding the taps along the row would read mid less
//   often but would add a tap's terms in another order. The
//   weight is staged once a CTA in the wrapper's layout (tap, s, encoder tap
//   t, ci; ci padded to a multiple of 4 by zeros; a (tap, s) row padded to
//   an odd number of 16-byte words, so that eight lanes' up-positions fall
//   in distinct banks). A tile's halo is staged as mid (cm channels padded
//   to cmp) in two buffers, the next tile's arriving by cp.async during
//   this one's work, and as y (nc classes padded to ncp) in one, the next
//   tile's issued once this one's reassembly has read it: both sit in
//   shared memory, since scattered reads of y through L1 (most of it given
//   to shared memory) wait on L2. Zeros outside the image and in the
//   padding. Logits leave as 16-byte runs of a pixel's classes (nc % 4 ==
//   0), else one value at a time; labels go to a stage laid out as the
//   tile's high-res rows (the depth-to-space in the stage's addresses) and
//   leave as 16-byte runs.
constexpr int F32_VEC = 4;       // floats in a 16-byte word
constexpr int F32_THREADS = 128;

template <int UP>
struct F32Shape {
  static constexpr int UP2 = UP * UP, ENC = 9 * UP2;
  static constexpr int PX = UP == 4 ? TW : 2;  // consecutive pixels a thread
  static constexpr int XG = TW / PX;           // threads along a tile row for one s
  static constexpr int PAD = UP == 4 ? 0 : F32_VEC;  // halo pixels' padding
  static_assert(UP2 * TH * XG == F32_THREADS, "one CTA shape");
};

// Shared memory of one CTA, in bytes: the encoder weight (9·up² (tap, s)
// rows of Ws floats: 9 encoder taps of cmp floats, padded to an odd number
// of 16-byte words), two halo tiles of mid (HALO_PX pixels of Ms floats),
// one of y (HALO_PX pixels of Ys floats), the labels' stage (the tile's
// up·TH x up·TW high-res pixels, int32; reserved in both modes), the
// encoder bias and the bias. At up 4 a warp's lanes read one or two halo
// pixels at a time (broadcasts); at up 2 eight, hence the padding there.
struct LayoutF32 {
  int cmp, ncp, Ws, Ms, Ys, w_off, mid_off, y_off, stage_off, benc_off, bias_off, total;
};

template <int UP>
__host__ __device__ LayoutF32 make_layout_f32(int cm, int nc) {
  using S = F32Shape<UP>;
  LayoutF32 L;
  L.cmp = round_up(cm, F32_VEC);
  L.ncp = round_up(nc, F32_VEC);
  L.Ws = 9 * L.cmp + (9 * L.cmp / F32_VEC % 2 ? 0 : F32_VEC);
  L.Ms = L.cmp + S::PAD;
  L.Ys = L.ncp + S::PAD;
  L.w_off = 0;
  L.mid_off = L.w_off + 9 * S::UP2 * L.Ws * 4;
  L.y_off = L.mid_off + 2 * HALO_PX * L.Ms * 4;
  L.stage_off = L.y_off + HALO_PX * L.Ys * 4;
  L.benc_off = L.stage_off + TH * UP * TW * UP * 4;
  L.bias_off = L.benc_off + round_up(S::ENC * 4, 16);
  L.total = L.bias_off + round_up(nc * 4, 16);
  return L;
}

// At most two CTAs an SM fit the shared memory of the sites, so the
// registers are not held below what the accumulators take.
template <int UP, bool LABELS>
__global__ void __launch_bounds__(F32_THREADS, 2)
carafe_f32_kernel(const float* __restrict__ gy, const float* __restrict__ wenc,
                  const float* __restrict__ benc, const float* __restrict__ bias,
                  void* __restrict__ out, int B, int H, int W, int G, int cm, int nc) {
  using S = F32Shape<UP>;
  constexpr int UP2 = S::UP2, ENC = S::ENC, PX = S::PX, XG = S::XG, NT = F32_THREADS;
  constexpr int RW = TW * UP;  // a staged high-res row
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutF32 L = make_layout_f32<UP>(cm, nc);
  const int cmp = L.cmp, Ms = L.Ms, Ys = L.Ys;
  float* Wsm = reinterpret_cast<float*>(smem + L.w_off);
  float* mids = reinterpret_cast<float*>(smem + L.mid_off);
  float* ys = reinterpret_cast<float*>(smem + L.y_off);
  int* stage = reinterpret_cast<int*>(smem + L.stage_off);
  float* benc_s = reinterpret_cast<float*>(smem + L.benc_off);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias_off);
  const int tid = threadIdx.x;
  const int s = tid % UP2, grp = tid / UP2, ly = grp / XG, lx0 = grp % XG * PX;
  const int TX = (W + TW - 1) / TW, TY = (H + TH - 1) / TH, tiles = B * TX * TY;
  const int HU = H * UP, WU = W * UP;
  const bool out_vec = nc % F32_VEC == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  for (int i = tid; i < 9 * UP2 * L.Ws / 4; i += NT) cp_async16(Wsm + 4 * i, wenc + 4 * i);
  for (int i = tid; i < ENC; i += NT) benc_s[i] = benc[i];
  for (int i = tid; i < nc; i += NT) bias_s[i] = bias[i];

  // The copies of channels [c0, c0 + n) of a tile's halo pixels into `dst`
  // (rows of `stride` floats, `chunks` 16-byte chunks a pixel): the values
  // past n and every pixel outside the image zero-filled. cp.async where c0
  // keeps the 16-byte words aligned, else one value at a time.
  const auto load_halo = [&](int tile, float* dst, int stride, int c0, int n, int chunks) {
    const int b = tile / (TX * TY), y0 = tile / TX % TY * TH, x0 = tile % TX * TW;
    for (int i = tid; i < HALO_PX * chunks; i += NT) {
      const int p = i / chunks, c = i % chunks * 4;
      const int y = y0 - 1 + p / HWD, x = x0 - 1 + p % HWD;
      const bool ok = y >= 0 && y < H && x >= 0 && x < W;
      const float* src = gy + (((size_t)b * H + y) * W + x) * G + c0 + c;
      if (c0 % F32_VEC == 0) {
        cp_async16(dst + p * stride + c, ok ? src : gy, ok ? 4 * min(F32_VEC, n - c) : 0);
      } else {
#pragma unroll
        for (int e = 0; e < F32_VEC; ++e)
          dst[p * stride + c + e] = ok && c + e < n ? src[e] : 0.f;
      }
    }
  };
  if (blockIdx.x < tiles) {
    load_halo(blockIdx.x, mids, Ms, 0, cm, cmp / 4);
    load_halo(blockIdx.x, ys, Ys, cm, nc, L.ncp / 4);
  }
  cp_async_commit();  // the weight and the first tile's halo

  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int next = tile + gridDim.x;
    if (next < tiles) load_halo(next, mids + ((it + 1) & 1) * HALO_PX * Ms, Ms, 0, cm, cmp / 4);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's mid and y (and, first, the weight) landed
    __syncthreads();
    const int b = tile / (TX * TY), y0 = tile / TX % TY * TH, x0 = tile % TX * TW;
    const float* hm = mids + (it & 1) * HALO_PX * Ms;

    // The encoder conv: e[j][t] = benc, then tap-major over ci.
    float e[PX][9];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int t = 0; t < 9; ++t) e[j][t] = benc_s[t * UP2 + s];
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* w = Wsm + (tap * UP2 + s) * L.Ws;
      const float* m = hm + ((ly + tap / 3) * HWD + lx0 + tap % 3) * Ms;
#pragma unroll 2
      for (int ci = 0; ci < cmp; ci += 4) {
        float4 mv[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) mv[j] = *reinterpret_cast<const float4*>(m + j * Ms + ci);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float4 wv = *reinterpret_cast<const float4*>(w + t * cmp + ci);
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            float a = e[j][t];
            a = fmaf(mv[j].x, wv.x, a);
            a = fmaf(mv[j].y, wv.y, a);
            a = fmaf(mv[j].z, wv.z, a);
            a = fmaf(mv[j].w, wv.w, a);
            e[j][t] = a;
          }
        }
      }
    }

    // The softmax over the 9 taps, then the reassembly, 4 classes at a
    // time: out[n] = Σ_t k[t]·y[tap t][n] + bias[n].
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      float mx = e[j][0];
#pragma unroll
      for (int t = 1; t < 9; ++t) mx = fmaxf(mx, e[j][t]);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        e[j][t] = expf(e[j][t] - mx);
        sum += e[j][t];
      }
#pragma unroll
      for (int t = 0; t < 9; ++t) e[j][t] = e[j][t] / sum;
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int lx = lx0 + j, y = y0 + ly, x = x0 + lx;
      const bool here = y < H && x < W;
      const float* yb = ys + (ly * HWD + lx) * Ys;
      const size_t opx = ((size_t)b * HU + y * UP + s / UP) * WU + x * UP + s % UP;
      float best = -INFINITY;
      int arg = 0;
      for (int n0 = 0; n0 < nc; n0 += 4) {
        float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float4 v = *reinterpret_cast<const float4*>(yb + ((t / 3) * HWD + t % 3) * Ys + n0);
          o[0] = fmaf(e[j][t], v.x, o[0]);
          o[1] = fmaf(e[j][t], v.y, o[1]);
          o[2] = fmaf(e[j][t], v.z, o[2]);
          o[3] = fmaf(e[j][t], v.w, o[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] += n0 + c < nc ? bias_s[n0 + c] : 0.f;
        if constexpr (LABELS) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (n0 + c < nc && o[c] > best) {
              best = o[c];
              arg = n0 + c;
            }
          }
        } else if (here) {
          float* dst = reinterpret_cast<float*>(out) + opx * nc + n0;
          if (out_vec) {
            *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
          } else {
            for (int c = 0; c < 4 && n0 + c < nc; ++c) dst[c] = o[c];
          }
        }
      }
      if constexpr (LABELS) stage[(ly * UP + s / UP) * RW + lx * UP + s % UP] = arg;
    }
    __syncthreads();  // y and the stage are read; y's buffer takes the next tile
    if (next < tiles) load_halo(next, ys, Ys, cm, nc, L.ncp / 4);
    cp_async_commit();

    if constexpr (LABELS) {
      // The staged high-res rows leave as 16-byte runs where whole and
      // aligned (W·up % 4 == 0), else one label at a time.
      constexpr int Q = RW / 4;
      for (int i = tid; i < TH * UP * Q; i += NT) {
        const int r = i / Q, c = i % Q * 4, gyr = y0 * UP + r, gx = x0 * UP + c;
        if (gyr >= HU || gx >= WU) continue;
        int* dst = reinterpret_cast<int*>(out) + ((size_t)b * HU + gyr) * WU + gx;
        if (WU % 4 == 0 && gx + 4 <= WU) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(stage + r * RW + c);
        } else {
          for (int e2 = 0; e2 < 4 && gx + e2 < WU; ++e2) dst[e2] = stage[r * RW + c + e2];
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int UP, bool LABELS>
cudaError_t launch_f32(const float* gy, const float* wenc, const float* benc,
                       const float* bias, void* out, int B, int H, int W, int G, int cm,
                       int nc, cudaStream_t stream) {
  constexpr int NT = F32_THREADS;
  const LayoutF32 L = make_layout_f32<UP>(cm, nc);
  const auto kernel = carafe_f32_kernel<UP, LABELS>;
  cudaError_t err = allow_smem(kernel, L.total);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, L.total);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;  // the weight and the halo exceed shared memory
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, NT, L.total, stream>>>(gy, wenc, benc, bias, out, B, H, W, G, cm, nc);
  return cudaGetLastError();
}

}  // namespace

// The float32 instances: gy (B, H, W, G) float32, 16-byte aligned, G >= cm +
// nc, G % 4 == 0; wenc: (3, 3, up², 9, cmp) float32 (kh, kw, the
// up-position s, the encoder tap t of output channel o = t·up² + s, then
// ci, zero from cm to cmp = cm rounded up to 4), 16-byte aligned; benc,
// bias as below; out: (B, up·H, up·W, nc) float32 logits, or int32 labels.
// Each (kh, kw, s) row of 9·cmp floats is padded by zeros to Ws
// (make_layout_f32; kernels.carafe_f32_plan mirrors it).
CSWIN_API int cswin_carafe_f32(const void* gy, const void* wenc, const void* benc,
                               const void* bias, void* out, int B, int H, int W, int G,
                               int cm, int nc, int up, int labels, void* stream) {
  if (cm < 1 || nc < 1 || G < cm + nc || G % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* g = (const float*)gy;
  const float* w = (const float*)wenc;
  const float* be = (const float*)benc;
  const float* bo = (const float*)bias;
#define CSWIN_CARAFE(UP, LB) (int)launch_f32<UP, LB>(g, w, be, bo, out, B, H, W, G, cm, nc, s)
  switch (up) {
    case 2: return labels ? CSWIN_CARAFE(2, true) : CSWIN_CARAFE(2, false);
    case 4: return labels ? CSWIN_CARAFE(4, true) : CSWIN_CARAFE(4, false);
  }
#undef CSWIN_CARAFE
  return (int)cudaErrorInvalidValue;
}

// The float32 kernel's dynamic shared memory (G does not enter it: only
// mid is staged), or -1 for an up it does not take: what
// kernels.py::carafe_f32_plan mirrors.
CSWIN_API int cswin_carafe_f32_smem(int cm, int nc, int G, int up) {
  (void)G;
  switch (up) {
    case 2: return make_layout_f32<2>(cm, nc).total;
    case 4: return make_layout_f32<4>(cm, nc).total;
  }
  return -1;
}

// gy: (B, H, W, G) bf16, 16-byte aligned, G >= cm + nc, G % 8 == cm % 8 ==
// 0; wenc: (9·up², 3, 3, cm) bf16 (output channel o = tap·up² + s, then kh,
// kw, ci), 16-byte aligned; benc: (9·up²,) f32; bias: (nc,) f32; out: (B,
// up·H, up·W, nc) bf16 logits, or (B, up·H, up·W) int32 labels when
// `labels` is non-zero. up must be 2 or 4.
CSWIN_API int cswin_carafe(const void* gy, const void* wenc, const void* benc,
                           const void* bias, void* out, int B, int H, int W, int G,
                           int cm, int nc, int up, int labels, void* stream) {
  if (cm < 1 || nc < 1 || G < cm + nc || G % 8 || cm % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* g = (const bf16*)gy;
  const bf16* w = (const bf16*)wenc;
  const float* be = (const float*)benc;
  const float* bo = (const float*)bias;
#define CSWIN_CARAFE(UP, LB) (int)launch<UP, LB>(g, w, be, bo, out, B, H, W, G, cm, nc, s)
  switch (up) {
    case 2: return labels ? CSWIN_CARAFE(2, true) : CSWIN_CARAFE(2, false);
    case 4: return labels ? CSWIN_CARAFE(4, true) : CSWIN_CARAFE(4, false);
  }
#undef CSWIN_CARAFE
  return (int)cudaErrorInvalidValue;
}
