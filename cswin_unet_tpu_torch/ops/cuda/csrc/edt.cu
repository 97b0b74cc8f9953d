// Exact 1-D squared-EDT min-plus pass along one axis of a float32 volume:
//   g[i] = min_j (i - j)^2 + f[j]
// with the volume contiguous and viewed as (outer, L, inner), the pass
// running along L. Three passes (one per axis) give the exact squared
// euclidean distance transform (ops/edt.py::edt_sq).
//
// Replaces: cswin_unet_tpu/ops/edt.py::edt_pass (pallas_call :73, body
//   _edt_pass_kernel :32), a brute-force min over L candidates per output
//   along the last axis only (moveaxis copies for the others); here any
//   axis is read in place, in O(L) a line.
// Bound on the H100: memory. The pass reads f and writes g once (8 bytes an
//   element) and does a few tens of operations an element, far under the
//   card's ~20 operations a byte.
// Algorithm (Felzenszwalb-Huttenlocher): (i - j)^2 + f[j] = i^2 - 2ij + F(j)
//   with F(j) = f[j] + j^2, so the minimisers over i are the points of the
//   lower convex hull of (j, F(j)), in order of j. The hull is built as a
//   stack of 16-bit indices in shared memory (each j pushed once, popped at
//   most once), then i walks from 0 to L - 1, moving to the next hull point
//   while that is at least as good, and the pass writes
//   fl((i - v)^2 + f[v]) in float32 with (i - v)^2 exact: the plain
//   version's candidate for j = v. Rounding is monotone, so where v is a
//   minimiser in real arithmetic this equals the plain version's min over j
//   of the rounded candidates, bit for bit.
// Exactness: both predicates are decided exactly, on the staged float32
//   values, so v is a real minimiser.
//   Pop b (a < b < q on the stack / line): the sign of
//     d1·f[q] + d2·f[a] - (d1 + d2)·f[b] + d1·d2·(d1 + d2),  d1 = b - a,
//     d2 = q - b  (<= 0: b is on or above the segment a-q, never the unique
//     minimiser).
//   Move from v to the next hull point w at i: the sign of
//     f[w] - f[v] + (w - v)·(v + w - 2i)   (<= 0: w is at least as good).
//   Where every value a predicate reads is an integer of magnitude <= 2^40
//   and L <= 2048 (all that edt_sq gives: 0, 1e12 = 999999995904 and their
//   sums with squared integer distances, never above 1e12, since a pass
//   never raises a value), it is evaluated in int64 on the values converted
//   once a point, and is exact: every product is an integer below 2^51,
//   every partial sum below 2^53 (so float64 would be exact too). Any
//   other finite float32 input takes an error-free form: each product of a
//   float32 by an integer below 2^12 is exact in float64, and the sign of
//   the sum of the (up to four) exact terms is read from their expansion
//   (Shewchuk's Grow-Expansion of TwoSums: non-overlapping components, the
//   largest nonzero one carries the sign). +inf values are never a
//   minimiser and are skipped (a line of +inf alone stays +inf); a line with
//   a NaN comes back NaN, one with -inf (and no NaN) -inf, as the plain min
//   gives them.
// A line whose values are all equal (and not NaN) comes back as it is:
//   the pass writes fl(0 + f[i]), the candidate j = i, at once, without a
//   hull (the rows of a volume's first pass that meet no seed).
// Pruning: a point whose value exceeds m + (L - 1)^2, m the line's least
//   finite value, is worse than m's point at every output and never joins
//   a hull (the bound is summed in float64 with a margin that covers its
//   rounding, then rounded down to float32, where the test is exact). It
//   keeps the 1e12 of a line with a seed off the stacks.
// Design: lane k of a warp serves line k of the warp's 32, so that every
//   lane runs the same steps on its own line; a line is cut into P parts
//   (1 to 8, from L) served by P warps, since one lane walking a whole line
//   is a chain of dependent steps and a pass has few lines for the SMs
//   (24,576 of 512 a pass over a 512^2 volume's rows). The CTA of eight
//   warps stages its TL = 256 / P lines (fewer where a long line's tile
//   would pass 227 KB; all L values of each) in shared memory by 4-byte
//   cp.async, S[j][k] with a padded row so that both staging orders (along
//   j for the contiguous last axis, along k for columns) and the lanes'
//   reads at one j are free of bank conflicts. Warp (group, p) builds the
//   hull of part p of its group's lines into a stack of 16-bit indices;
//   the group's first warp merges the parts' hulls (a part's points join
//   the stack by the same pop test until two of them stand on it, after
//   which its convex rest stands too), leaving each part's surviving range;
//   warp (group, p) then writes the outputs of part p, starting from the
//   hull point a binary search over the merged hull finds for its first i
//   (the moves form a prefix there). The hull is the one a single pass over
//   the line builds, and the walk stops where a single walk would. The fast
//   predicates run in int64 on values converted once a point. Along
//   columns the walk's stores are coalesced as they stand (the lanes are
//   neighbouring columns); along the last axis each warp transposes 8
//   outputs of its 32 lines through a 32 x 9 buffer and writes 32-byte row
//   segments.

#include "common.cuh"

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr size_t SMEM_MAX = 232448;  // 227 KB, the most a CTA may opt into
constexpr int FAST_MAX_L = 2048;     // the fast predicates' bound on L
constexpr int TW = 9;                // a transpose buffer's row: 8 outputs, padded

// Parts a line is cut into: parts of at most 32 points where 8 allow.
int parts_for(int L) { return L <= 32 ? 1 : L <= 64 ? 2 : L <= 128 ? 4 : 8; }

// Dynamic shared memory of a CTA of TL lines of L in P parts: the last
// axis's transpose buffers (a 32 x TW buffer a warp), the staged tile S (L
// rows of TL + 1 floats), the parts' stacks (P x ceil(L / P) x TL 16-bit
// indices), their least and greatest values (2 x P x TL floats), sizes and
// merged ranges (3 x P x TL 16-bit) and flags (P x TL bytes). Mirrored by
// kernels.py::edt_pass_plan.
size_t smem_bytes(int L, int P, int TL, bool last) {
  const size_t seg = (L + P - 1) / P;
  return (last ? (size_t)WARPS * 32 * TW * 4 : 0) + (size_t)L * (TL + 1) * 4 +
         P * seg * TL * 2 + (size_t)P * TL * (2 * 4 + 3 * 2 + 1);
}

// Lines a CTA takes: 32 a group of P warps, fewer where a long line's tile
// would pass 227 KB; 0 if one line does not fit.
int lines_per_cta(int L, int P, bool last) {
  if (L < 1 || L > 65535) return 0;
  for (int tl = WARPS / P * 32; tl >= 1; tl -= tl > 32 ? 32 : 1)
    if (smem_bytes(L, P, tl, last) <= SMEM_MAX) return tl;
  return 0;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// Whether the fast predicates are exact on f: an integer of magnitude at
// most 2^40 (false for NaN and the infinities).
__device__ __forceinline__ bool small_int(float f) {
  return fabsf(f) <= 0x1p40f && f == truncf(f);
}

__device__ __forceinline__ double two_sum(double a, double b, double& err) {
  const double s = a + b, bb = s - a;
  err = (a - (s - bb)) + (b - bb);
  return s;
}

// The sign (-1, 0, 1) of a + b + c + d, exactly (no overflow): the
// expansion of the four by Grow-Expansion, then its largest nonzero
// component.
__device__ __forceinline__ int sign_sum4(double a, double b, double c, double d) {
  double e0, e1, e2;
  const double q = two_sum(b, a, e0);  // [e0, q]
  double r = two_sum(c, e0, e0);       // grow with c
  r = two_sum(r, q, e1);               // [e0, e1, r]
  double t = two_sum(d, e0, e0);       // grow with d
  t = two_sum(t, e1, e1);
  t = two_sum(t, r, e2);               // [e0, e1, e2, t]
  const double top = t != 0.0 ? t : e2 != 0.0 ? e2 : e1 != 0.0 ? e1 : e0;
  return (top > 0.0) - (top < 0.0);
}

// A point of a line: its index, value, and the value as an integer where
// the fast predicates take it.
struct Pt {
  int j;
  float f;
  long long n;
  bool small;
};

__device__ __forceinline__ Pt make_pt(int j, float f, bool fast_l) {
  Pt p;
  p.j = j;
  p.f = f;
  p.small = fast_l && small_int(f);
  p.n = p.small ? (long long)f : 0;
  return p;
}

// b (a < b < q) stays on the hull: F(b) lies strictly under the segment
// from (a, F(a)) to (q, F(q)).
__device__ __forceinline__ bool keep(const Pt& a, const Pt& b, const Pt& q) {
  const int d1 = b.j - a.j, d2 = q.j - b.j;
  const long long c = (long long)(d1 * d2) * (d1 + d2);
  if (a.small && b.small && q.small) return d1 * q.n + d2 * a.n - (d1 + d2) * b.n + c > 0;
  return sign_sum4((double)d1 * q.f, (double)d2 * a.f, -(double)(d1 + d2) * b.f,
                   (double)c) > 0;
}

// The hull point w > v is at least as good as v at i.
__device__ __forceinline__ bool advance(const Pt& v, const Pt& w, int i) {
  const int j = (w.j - v.j) * (v.j + w.j - 2 * i);
  if (v.small && w.small) return w.n - v.n + j <= 0;
  return sign_sum4(w.f, -(double)v.f, (double)j, 0.0) <= 0;
}

template <int P, bool LAST>
__global__ void __launch_bounds__(THREADS)
edt_pass_kernel(const float* __restrict__ f, float* __restrict__ g, long long n_lines,
                int L, long long inner, int TL) {
  extern __shared__ __align__(16) float smem[];
  const int LD = TL + 1, SEG = (L + P - 1) / P;
  float* T = smem;  // LAST: a 32 x TW buffer a warp
  float* S = T + (LAST ? WARPS * 32 * TW : 0);
  float* mins = S + (size_t)L * LD;  // [p * TL + r]: part p's least value
  float* maxs = mins + P * TL;        // and its greatest, NaN if it holds one
  uint16_t* st = reinterpret_cast<uint16_t*>(maxs + P * TL);  // part p, entry e:
                                                              // st[(p * SEG + e) * TL + r]
  uint16_t* cnt = st + (size_t)P * SEG * TL;  // [p * TL + r]: part p's hull size
  uint16_t* lo = cnt + P * TL;                // merged: part p's entries [lo, hi)
  uint16_t* hi = lo + P * TL;
  uint8_t* flags = reinterpret_cast<uint8_t*>(hi + P * TL);  // 1: a NaN, 2: a -inf
  const long long line0 = (long long)blockIdx.x * TL;
  const int lines = (int)(n_lines - line0 < TL ? n_lines - line0 : TL);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (LAST) {  // line r is the contiguous row line0 + r: read along j
    for (int r = warp; r < lines; r += WARPS) {
      const float* src = f + (line0 + r) * L;
      for (int j = lane; j < L; j += 32) cp_async4(&S[j * LD + r], src + j);
    }
  } else {     // neighbouring lines are neighbouring columns: read along r
    for (int r = lane; r < lines; r += 32) {
      const long long t = line0 + r;
      const float* src = f + (t / inner) * L * inner + t % inner;
      for (int j = warp; j < L; j += WARPS) cp_async4(&S[j * LD + r], src + (long long)j * inner);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int p = warp % P, r = warp / P * 32 + lane;  // this lane's part and line
  const bool active = r < lines, fast_l = L <= FAST_MAX_L;
  const float* col = S + r;  // f[j] at col[j * LD]
  const int j0 = p * SEG, j1 = j0 + SEG < L ? j0 + SEG : L;
  const auto entry = [&](int q, int e) { return (int)st[((size_t)q * SEG + e) * TL + r]; };
  const auto pt = [&](int j) { return make_pt(j, col[j * LD], fast_l); };

  // The line's least value, for the pruning bound, and its greatest, to
  // find lines of one value (a NaN sticks to the greatest).
  const auto most = [](float a, float b) { return a != a || b != b ? NAN : fmaxf(a, b); };
  if (active) {
    float m = INFINITY, mx = -INFINITY;
    for (int j = j0; j < j1; ++j) {
      m = fminf(m, col[j * LD]);
      mx = most(mx, col[j * LD]);
    }
    mins[p * TL + r] = m;
    maxs[p * TL + r] = mx;
  }
  __syncthreads();
  float m = INFINITY, mx = -INFINITY;
  if (active) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      m = fminf(m, mins[q * TL + r]);
      mx = most(mx, maxs[q * TL + r]);
    }
  }
  const bool one_value = m == mx;  // every point its own minimiser

  // The lower hull of (j, F(j)) over this part's finite values that may
  // win: those not above m + (L - 1)^2 (with a margin of at least one
  // float64 ulp of the bound).
  if (active && !one_value) {
    const double t = (double)m + (double)(L - 1) * (double)(L - 1);
    // fq > bound holds for a float32 fq exactly when fq > bound rounded down
    const float bound = __double2float_rd(t + fabs(t) * 0x1p-52);
    uint16_t* sq = st + (size_t)p * SEG * TL + r;  // entry e at sq[e * TL]
    int n = 0;
    uint8_t fl = 0;
    Pt a{}, b{};
    for (int q = j0; q < j1; ++q) {
      const float fq = col[q * LD];
      if (!(fabsf(fq) < INFINITY)) {  // NaN or an infinity: never on the hull
        fl |= fq != fq ? 1 : fq < 0.f ? 2 : 0;
        continue;
      }
      if (fq > bound) continue;
      const Pt c = make_pt(q, fq, fast_l);
      while (n >= 2 && !keep(a, b, c)) {
        --n;
        b = a;
        if (n >= 2) a = pt(sq[(n - 2) * TL]);
      }
      sq[n * TL] = (uint16_t)q;
      ++n;
      a = b;
      b = c;
    }
    cnt[p * TL + r] = (uint16_t)n;
    flags[p * TL + r] = fl;
  }
  __syncthreads();

  // The group's first warp merges the parts' hulls into ranges [lo, hi)
  // of their entries; the stack's top two are (ts, tp) and (ss, sp).
  if (p == 0 && active && !one_value) {
    int size = 0, ts = 0, tp = 0, ss = 0, sp = 0;
    uint8_t fl = 0;
    Pt top{}, sec{};
    for (int w = 0; w < P; ++w) {
      fl |= flags[w * TL + r];
      const int n = cnt[w * TL + r];
      int l = 0, h = 0;
      for (int t = 0; t < n; ++t) {
        const Pt q = pt(entry(w, t));
        while (size >= 2 && !keep(sec, top, q)) {  // pop the top
          if (ts == w) h = tp;
          else hi[ts * TL + r] = (uint16_t)tp;
          --size;
          top = sec;
          ts = ss;
          tp = sp;
          if (size >= 2) {  // the element under the new top
            if (ss == w ? sp > l : sp > lo[ss * TL + r]) {
              --sp;
            } else {
              do --ss; while (hi[ss * TL + r] == lo[ss * TL + r]);
              sp = hi[ss * TL + r] - 1;
            }
            sec = pt(entry(ss, sp));
          }
        }
        if (h == l) l = t;  // push q
        h = t + 1;
        ++size;
        sec = top;
        ss = ts;
        sp = tp;
        top = q;
        ts = w;
        tp = t;
        if (h - l >= 2) {  // two of this part stand: so does its convex rest
          size += n - h;
          if (n > h) {
            top = pt(entry(w, n - 1));
            sec = pt(entry(w, n - 2));
            tp = n - 1;
            ss = w;
            sp = n - 2;
          }
          h = n;
          break;
        }
      }
      lo[w * TL + r] = (uint16_t)l;
      hi[w * TL + r] = (uint16_t)h;
    }
    cnt[r] = (uint16_t)size;
    flags[r] = fl;
  }
  __syncthreads();

  // Warp (group, p) writes the outputs of part p of its lines.
  const int fl = active && !one_value ? flags[r] : 0;
  const int N = active && !one_value ? cnt[r] : 0;
  const bool walk = active && fl == 0 && N > 0;
  const float fill = fl & 1 ? NAN : fl & 2 ? -INFINITY : INFINITY;
  int los[P], lens[P];
#pragma unroll
  for (int w = 0; w < P; ++w) {
    los[w] = walk ? lo[w * TL + r] : 0;
    lens[w] = walk ? hi[w * TL + r] - los[w] : 0;
  }
  const auto locate = [&](int h, int& w0, int& e) {  // the h-th point of the merged hull
    w0 = 0;
    e = 0;
#pragma unroll
    for (int w = 0; w < P; ++w) {
      if (h >= 0 && h < lens[w]) {
        w0 = w;
        e = los[w] + h;
      }
      h -= lens[w];
    }
  };
  int h = 0, nw = 0, ne = 0;  // the next point: entry ne of part nw
  Pt v{}, nx{};
  const auto next = [&]() {  // the point after (nw, ne)
    if (++ne == hi[nw * TL + r]) {
      do ++nw; while (hi[nw * TL + r] == lo[nw * TL + r]);
      ne = lo[nw * TL + r];
    }
    nx = pt(entry(nw, ne));
  };
  if (walk && j0 < j1) {
    int a = 0, b = N - 1;  // the first h whose next point is worse at j0
    while (a < b) {
      const int m = (a + b) / 2;
      int w1, e1, w2, e2;
      locate(m, w1, e1);
      locate(m + 1, w2, e2);
      if (advance(pt(entry(w1, e1)), pt(entry(w2, e2)), j0)) a = m + 1;
      else b = m;
    }
    h = a;
    locate(h, nw, ne);
    v = pt(entry(nw, ne));
    if (h + 1 < N) next();
  }
  const auto value = [&](int i) -> float {
    if (one_value) return 0.f + col[i * LD];
    if (!walk) return fill;
    while (h + 1 < N && advance(v, nx, i)) {
      ++h;
      v = nx;
      if (h + 1 < N) next();
    }
    const float d = (float)(i - v.j);
    return d * d + v.f;
  };

  if (LAST) {
    if (warp / P * 32 >= lines) return;  // no line for this warp's group
    float* Tw = T + warp * 32 * TW;
    const int r0 = warp / P * 32, wl = lines - r0 < 32 ? lines - r0 : 32;
    for (int c0 = j0; c0 < j1; c0 += 8) {
      const int m = j1 - c0 < 8 ? j1 - c0 : 8;
      if (active)
        for (int c = 0; c < m; ++c) Tw[lane * TW + c] = value(c0 + c);
      __syncwarp();
      for (int q = lane / 8; q < wl; q += 4)  // 4 rows of 8 a store
        if (lane % 8 < m) g[(line0 + r0 + q) * L + c0 + lane % 8] = Tw[q * TW + lane % 8];
      __syncwarp();
    }
  } else if (active) {
    const long long t = line0 + r;
    float* out = g + (t / inner) * L * inner + t % inner;
    for (int i = j0; i < j1; ++i) out[(long long)i * inner] = value(i);
  }
}

template <int P, bool LAST>
cudaError_t launch(const float* f, float* g, long long n_lines, int L, long long inner,
                   cudaStream_t stream) {
  const int TL = lines_per_cta(L, P, LAST);
  if (TL < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L, P, TL, LAST);
  cudaError_t err = allow_smem(edt_pass_kernel<P, LAST>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (n_lines + TL - 1) / TL;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  edt_pass_kernel<P, LAST><<<(unsigned)blocks, THREADS, smem, stream>>>(f, g, n_lines, L,
                                                                        inner, TL);
  return cudaGetLastError();
}

template <bool LAST>
cudaError_t launch_any(const float* f, float* g, long long n_lines, int L, long long inner,
                       cudaStream_t stream) {
  switch (parts_for(L)) {
    case 1: return launch<1, LAST>(f, g, n_lines, L, inner, stream);
    case 2: return launch<2, LAST>(f, g, n_lines, L, inner, stream);
    case 4: return launch<4, LAST>(f, g, n_lines, L, inner, stream);
    default: return launch<8, LAST>(f, g, n_lines, L, inner, stream);
  }
}

}  // namespace

// f, g: contiguous float32 (outer, L, inner); g may not alias f. L from 1
// to the longest line a CTA's shared memory holds (cswin_edt_pass_lines).
CSWIN_API int cswin_edt_pass(const void* f, void* g, long long outer, int L,
                             long long inner, void* stream) {
  const long long n_lines = outer * inner;
  if (n_lines <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (inner == 1) return (int)launch_any<true>((const float*)f, (float*)g, n_lines, L, inner, s);
  return (int)launch_any<false>((const float*)f, (float*)g, n_lines, L, inner, s);
}

// Lines a CTA of the pass takes at L (last: along the contiguous axis), 0
// where one line does not fit: what kernels.py::edt_pass_plan mirrors.
CSWIN_API int cswin_edt_pass_lines(int L, int last) {
  return lines_per_cta(L, parts_for(L), last != 0);
}
