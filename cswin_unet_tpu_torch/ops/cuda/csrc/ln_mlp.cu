// The MLP half of a CSWin block in one launch, the 4C-wide hidden never
// leaving registers:
//
//   out = x + fc2(act(fc1(LN(x))))            rows of width C = 64, hidden 256
//
// rounding to bf16 where the block's composition rounds (cswin_block.py
// _layernorm / _dot, :84-96): the LN output, the fc1 output (with its bias),
// the activation, the fc2 output (with its bias), then the residual sum.
// Compile-time modes, each a kernel the TPU experiments priced:
//   ACT   0: exact erf GELU; 1: the clamp v · min(max(v + 0.5, 0), 1)
//         (a stand-in of the same shape without the erf)
//   LN    off: fc1 reads x as it is
//   FOLD  no fc2 and no residual: the activated hidden, unrounded, summed
//         over its four C-wide groups in float32, rounded once
//
// Replaces: the MLP kernels of scripts/exp_pack.py:60 (k64, k64g2, k64mm,
//   k128), scripts/exp_lane.py:67 (k_mlp_u, k_mlp_p) and scripts/exp_vpu.py:43
//   (k_gelu, k_gelu_tanhless). The lane-paired forms there (two pixels or two
//   images side by side on 128 lanes, block-diagonal weights) compute this
//   function of the unpaired view of the same bytes.
// Bound on the H100: bytes. A row moves 256 bytes (x read, out written) and
//   takes 2·2·64·256 tensor-core flops: at 401,408 rows 0.0307 ms of bytes
//   against 0.0266 ms of bf16 products and 0.0184 ms of float32 work (LN and
//   the activation, ~10 operations a hidden value), the pipes side by side.
//   The erf alone is ~20 instructions a hidden value, so the GELU modes
//   issue-bound well above that (a table of bf16 GELU values, the inputs
//   being bf16, gives the same bits but ran 25% slower on an H100: its
//   random shared-memory reads conflict). The chain of three launches (LN, fc1 +
//   GELU, fc2 + residual) moves the hidden to memory and back, 6.5x the
//   bytes.
// Design: persistent CTAs of WG warpgroups, one an SM (the occupancy API
//   sizes the wave), walk tiles of 64·WG rows cta, cta + grid, .... Each CTA
//   copies both weight matrices into shared memory once, in wgmma's K-major
//   layout without swizzle (8x8 core matrices of 128 contiguous bytes), and
//   the biases beside them. The rows come through a ring of two tiles filled
//   with 16-byte cp.async copies, the next tile's copies in flight under this
//   tile's math. LN runs layernorm_row.cuh's rows (the bits of every other LN
//   of the port) from the ring into a normalised tile. A warpgroup takes 64
//   rows, a warp 16 of them, whose fc1 A operand stays in registers (four
//   k16 fragments, loaded once by ldmatrix). The hidden goes in four chunks
//   of 64: fc1 is an asynchronous wgmma m64n64k16 with A from registers and
//   B from shared memory; the chunk after this one is issued before this
//   one's epilogue, so the tensor cores run under the float32 work. The
//   epilogue on the accumulators (bias, bf16 rounding, activation, bf16
//   rounding) repacks them in registers as fc2's A operand: two adjacent n8
//   accumulator tiles are one k16 fragment (the accumulator's layout is
//   mma.m16n8k16's C a warp, its A operand's A). fc2 accumulates in
//   registers over the hidden, asynchronously too. The output tile (bias,
//   rounding, the residual from x still in the ring) goes through the warp's
//   own rows of shared memory to 16-byte stores. FOLD adds each chunk's
//   activations into the registers fc2 would use, in float32, group by group.

#include "gemm_tile.cuh"
#include "layernorm_row.cuh"
#include "persistent.cuh"

namespace {

constexpr int C = 64, HID = 256;
constexpr int WG = 3;               // warpgroups a CTA
constexpr int BM = 64 * WG;         // rows a tile: 64 a warpgroup, 16 a warp
constexpr int WARPS = 4 * WG, THREADS = WARPS * 32;
constexpr int STAGES = 2;           // tiles in the ring
constexpr int LDX = C + 8;          // padded row of x and the normalised tile
constexpr int CHUNKS = HID / C;     // fc1's N and fc2's K a chunk: C

struct __align__(128) Smem {
  bf16 W1[HID * C];          // fc1_w (hidden, C) as 8x8 core matrices, K-major
  bf16 W2[C * HID];          // fc2_w (C, hidden) likewise
  float b1[HID];             // fc1_b, zero when absent
  float b2[C];               // fc2_b, zero when absent
  bf16 X[STAGES][BM][LDX];   // the ring of row tiles
  bf16 Y[BM][LDX];           // LN(x); then each warp's output rows
};
static_assert(sizeof(Smem) <= persistent::SMEM_MAX, "one CTA's shared memory");

// Where the 16 bytes of row n, columns [8k8, 8k8 + 8) of an (N, K) K-major
// matrix go in the core-matrix layout: core matrix (n/8, k8) at
// ((n/8)·(K/8) + k8)·64 elements, its row n%8 8 elements on. wgmma then
// reads K-adjacent core matrices 128 bytes apart (LBO) and N-adjacent ones
// K/8·128 bytes apart (SBO).
__device__ __forceinline__ int core_offset(int n, int k8, int K) {
  return ((n >> 3) * (K / 8) + k8) * 64 + (n & 7) * 8;
}

// The shared-memory matrix descriptor of a K-major operand without swizzle.
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, int lbo, int sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= a · B over one k16 step: the warpgroup's 64 rows times 64 columns,
// a the warp's 16 rows in registers (mma.m16n8k16's A layout), B through a
// descriptor; accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <int ACT>
__device__ __forceinline__ float activation(float v) {
  if constexpr (ACT == 0) return gemm_tile::gelu_erf(v);
  return v * fminf(fmaxf(v + 0.5f, 0.f), 1.f);
}

// Rows [m0, m0 + BM) of x into a ring stage; rows past M are zero-filled.
__device__ __forceinline__ void load_rows(const bf16* __restrict__ x, int M, int m0,
                                          bf16 (*X)[LDX]) {
  for (int i = threadIdx.x; i < BM * C / 8; i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 8, gm = m0 + r;
    cp_async16(&X[r][c], x + (size_t)(gm < M ? gm : M - 1) * C + c, gm < M ? 16 : 0);
  }
}

// fc1 for hidden chunk h (columns [64h, 64h + 64)): four k16 steps.
__device__ __forceinline__ void fc1_chunk(float (&acc)[32], const uint32_t (&a1)[C / 16][4],
                                          const bf16* W1, int h) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
    wgmma_64x64(acc, a1[kk], smem_desc(W1 + core_offset(h * C, 2 * kk, C), 128, C / 8 * 128),
                kk > 0);
  wg_commit();
}

template <int ACT, bool LN, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ nw,
              const float* __restrict__ nb, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const float* __restrict__ b2, bf16* __restrict__ out, int M, float eps,
              int tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int r0 = warp * 16;  // the warp's first row of a tile
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;  // ldmatrix.x4 of an A fragment

  for (int i = tid; i < HID * C / 8; i += THREADS)
    cp_async16(sm.W1 + core_offset(i >> 3, i & 7, C), w1 + (size_t)i * 8);
  if constexpr (!FOLD)
    for (int i = tid; i < C * HID / 8; i += THREADS)
      cp_async16(sm.W2 + core_offset(i >> 5, i & 31, HID), w2 + (size_t)i * 8);
  for (int i = tid; i < HID; i += THREADS) sm.b1[i] = b1 != nullptr ? b1[i] : 0.f;
  if (tid < C) sm.b2[tid] = !FOLD && b2 != nullptr ? b2[tid] : 0.f;
  int t = blockIdx.x;
  if (t < tiles) load_rows(x, M, t * BM, sm.X[0]);
  cp_async_commit();

  for (int i = 0; t < tiles; ++i, t += gridDim.x) {
    const int s = i & 1, m0 = t * BM;
    if (t + (int)gridDim.x < tiles) load_rows(x, M, (t + gridDim.x) * BM, sm.X[s ^ 1]);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows (and, the first time, the weights)
    // the weights, written through the generic proxy, are read by wgmma's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    bf16(*A)[LDX] = sm.X[s];
    if constexpr (LN) {
      ln_row::rows_any(&sm.X[s][0][0], LDX, nw, nb, &sm.Y[0][0], LDX, min(BM, M - m0), C, eps,
                       THREADS, 0, 1);
      __syncthreads();
      A = sm.Y;
    }
    uint32_t a1[C / 16][4];  // fc1's A: the warp's 16 rows, all of K = C
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) ldsm_x4(a1[kk], &A[r0 + a_row][kk * 16 + a_col]);

    // acc2: fc2's sums, or with FOLD the folded activations; n8 tile j of
    // the 64 columns in acc2[4j .. 4j + 3] (rows g, g, g + 8, g + 8, columns
    // 8j + 2q, 8j + 2q + 1), as in acc1.
    float acc2[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc2[e] = 0.f;
    float acc1[2][32];  // two chunks' fc1 sums, in turns
    fc1_chunk(acc1[0], a1, sm.W1, 0);
#pragma unroll
    for (int h = 0; h < CHUNKS; ++h) {
      if (h + 1 < CHUNKS) {
        fc1_chunk(acc1[(h + 1) & 1], a1, sm.W1, h + 1);
        wg_wait<1>();  // chunk h's fc1 (and chunk h - 1's fc2) done
      } else {
        wg_wait<0>();
      }
      const float(&d)[32] = acc1[h & 1];
      uint32_t a2[C / 16][4];  // fc2's A over this chunk's 64 hidden columns
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(&sm.b1[h * C + j * 8 + 2 * q]);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = activation<ACT>(round_bf16(d[4 * j + e] + ((e & 1) ? bb.y : bb.x)));
        if constexpr (FOLD) {  // each activation rounded to float32, then added
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[4 * j + e] = __fadd_rn(acc2[4 * j + e], v[e]);
        } else {
          a2[j >> 1][(j & 1) * 2] = pack_bf16(v[0], v[1]);
          a2[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
        }
      }
      if constexpr (!FOLD) {
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
          wgmma_64x64(acc2, a2[kk],
                      smem_desc(sm.W2 + core_offset(0, h * (C / 8) + 2 * kk, HID), 128,
                                HID / 8 * 128),
                      1);
        wg_commit();
      }
    }
    wg_wait<0>();

    __syncwarp();  // the warp's rows of Y (its A with LN) take its output
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int c0 = j * 8 + 2 * q;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + g + hr * 8;
        const float s0 = acc2[4 * j + 2 * hr], s1 = acc2[4 * j + 2 * hr + 1];
        uint32_t o;
        if constexpr (FOLD) {
          o = pack_bf16(s0, s1);
        } else {
          const float2 xr = unpack_bf16(*reinterpret_cast<const uint32_t*>(&sm.X[s][r][c0]));
          o = pack_bf16(xr.x + round_bf16(s0 + sm.b2[c0]), xr.y + round_bf16(s1 + sm.b2[c0 + 1]));
        }
        *reinterpret_cast<uint32_t*>(&sm.Y[r][c0]) = o;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 16 * C / 8 / 32; ++k) {
      const int idx = k * 32 + lane, r = idx >> 3, c0 = (idx & 7) * 8, gm = m0 + r0 + r;
      if (gm < M)
        *reinterpret_cast<uint4*>(out + (size_t)gm * C + c0) =
            *reinterpret_cast<const uint4*>(&sm.Y[r0 + r][c0]);
    }
    __syncthreads();  // the ring stage and Y are restaged
  }
  cp_async_wait<0>();
}

struct Plan {
  int tiles, smem, ctas_per_sm, grid;
};

template <int ACT, bool LN, bool FOLD>
cudaError_t plan(int M, Plan& p) {
  p.tiles = (int)(((long long)M + BM - 1) / BM);
  p.smem = (int)sizeof(Smem);
  int sms = 0;
  const cudaError_t e =
      persistent::occupancy(ln_mlp_kernel<ACT, LN, FOLD>, THREADS, p.smem, p.ctas_per_sm, sms);
  if (e != cudaSuccess) return e;
  const long long wave = (long long)p.ctas_per_sm * sms;
  p.grid = (int)(p.tiles < wave ? p.tiles : wave);
  return cudaSuccess;
}

template <int ACT, bool LN, bool FOLD>
int launch(const void* x, const void* nw, const void* nb, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int M, float eps, void* stream,
           int* info) {
  Plan p;
  const cudaError_t e = plan<ACT, LN, FOLD>(M, p);
  if (e != cudaSuccess) return (int)e;
  if (info != nullptr) {  // the plan only
    const int v[6] = {BM, STAGES, p.smem, p.tiles, p.ctas_per_sm, p.grid};
    for (int i = 0; i < 6; ++i) info[i] = v[i];
    return 0;
  }
  ln_mlp_kernel<ACT, LN, FOLD><<<p.grid, THREADS, p.smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)nw, (const float*)nb, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2, (const float*)b2, (bf16*)out, M, eps, p.tiles);
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* nw, const void* nb, const void* w1, const void* b1,
             const void* w2, const void* b2, void* out, int M, int channels, int hidden,
             float eps, int act, int ln, int fold, void* stream, int* info) {
  if (channels != C || hidden != HID || M < 1 || act < 0 || act > 1)
    return (int)cudaErrorInvalidValue;
#define CSWIN_LN_MLP(ACT, LN, FOLD) \
  launch<ACT, LN, FOLD>(x, nw, nb, w1, b1, w2, b2, out, M, eps, stream, info)
  switch (act * 4 + (ln != 0) * 2 + (fold != 0)) {
    case 0: return CSWIN_LN_MLP(0, false, false);
    case 1: return CSWIN_LN_MLP(0, false, true);
    case 2: return CSWIN_LN_MLP(0, true, false);
    case 3: return CSWIN_LN_MLP(0, true, true);
    case 4: return CSWIN_LN_MLP(1, false, false);
    case 5: return CSWIN_LN_MLP(1, false, true);
    case 6: return CSWIN_LN_MLP(1, true, false);
    default: return CSWIN_LN_MLP(1, true, true);
  }
#undef CSWIN_LN_MLP
}

}  // namespace

// x, out: (M, C) bf16, contiguous, 16-byte aligned; nw, nb: (C,) float32
// (unread with ln = 0); w1: (hidden, C) bf16 and w2: (C, hidden) bf16, the
// torch Linear layout (w2 unread with fold = 1); b1: (hidden,), b2: (C,)
// float32 or null. act 0: erf GELU, 1: clamp. Only C = 64 with hidden = 256
// is compiled (the stage-1 width of tiny-224); anything else returns
// cudaErrorInvalidValue. Requires 16-byte aligned w1 and w2 (checked by the
// wrapper).
CSWIN_API int cswin_ln_mlp(const void* x, const void* nw, const void* nb, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, int M,
                           int channels, int hidden, float eps, int act, int ln, int fold,
                           void* stream) {
  return dispatch(x, nw, nb, w1, b1, w2, b2, out, M, channels, hidden, eps, act, ln, fold,
                  stream, nullptr);
}

// The plan a launch of M rows in this mode takes (mirrored by
// kernels.py::ln_mlp_plan): info[0..5] = rows a tile, ring stages, shared
// bytes, tiles, CTAs an SM, grid. Returns the entry's refusal, if any.
CSWIN_API int cswin_ln_mlp_plan(int M, int act, int ln, int fold, int* info) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, M,
                  C, HID, 1e-5f, act, ln, fold, nullptr, info);
}
