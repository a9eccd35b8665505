// Coordinate-wise robust statistics over the worker axis, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/coord_stats/kernel.py::coord_stats_pallas, both
// bodies (_make_kernel, unmasked, and _make_masked_kernel, masked): the
// coordinate-wise median, trimmed mean, MeaMed and Phocas of the
// worker-major (W, N) gradient buffer, and Bulyan's coordinate stage
// (MeaMed over the picked workers).  out[n] is fp32; X is fp32 or bf16,
// read in place through a row stride and loaded as fp32.
//
// Options.  `mask` (R floats, 0 = inactive) leaves workers out; every
// position then comes from W_a = max(#active, 1), read once per block.
// `rows` (R int32) names the rows of X to read, in that order, as workers
// 0..R-1: Bulyan reads its picked workers in pick order without a gathered
// (theta, N) copy.  Without a mask W_a = R, so one body serves both cases:
//   trimmed mean  kt = min(f, (W_a - 1) / 2) trimmed per side;
//   MeaMed/Phocas ka = max(W_a - f, 1) values nearest the center;
//   median        (S[(W_a - 1) / 2] + S[W_a / 2]) * 0.5, jnp.median's formula.
//
// Bound.  A coordinate costs R loads of 4 (fp32) or 2 (bf16) bytes and one
// 4-byte store; at W = 15 that is 64 bytes against ~120-200 fp32
// operations, so the card's bytes bound it (6.91 ms over N = 361,821,120
// at 3.35 TB/s; chip_smoke.py prints both bounds).  The kernel it replaced
// here was issue-bound (an odd-even network over a padded width, a second
// key-value sort for MeaMed), so the design cuts instructions per
// coordinate and overlaps the loads with the work:
//
// Design.  One thread owns one coordinate (grid-stride loop); a warp reads
// 32 neighbouring columns of one row per load.
//  * Exact widths.  The kernel is instantiated on R itself for R <= 16 (the
//    paper's W = 15, Bulyan's theta = 9), on 32, 64 or 128 above, the tail
//    +inf.  The network is Batcher's merge-exchange sort, generated into
//    sort_networks.cuh (59 min/max compare-exchanges at 15, 26 at 9).
//    Every register index is a compile-time constant: at an exact width a
//    switch on the block-uniform W_a (R unmasked) picks the median's pair
//    (s[(W_a-1)/2] + s[W_a/2]) * 0.5, with no runtime read.
//  * Only active rows are read.  The mask is block-uniform (a bit set in a
//    register); an inactive worker is +inf without a load, and sorts to
//    the top.  With `rows=`, only the R picked rows are read.
//  * The next column is loaded into registers before this one is sorted
//    (kPrefetch, from kPrefetchFrom rows up), so its loads are in flight
//    during the network.  On the card this reaches the time of the same
//    walk with no network at all (launch/coord_probe.py's loads_only;
//    without the prefetch MeaMed took ~15 % longer, PERF.md).  Below 7
//    rows a column is little work and the prefetch is left out (ptxas
//    spilled a register there to stay at 32).
//  * MeaMed and Phocas take a window of the one sort.  The ka values
//    nearest c, as a multiset, are s[lo .. lo + ka): lo counts the leading
//    positions i whose window end is nearer the center,
//    s[i + ka] - c < c - s[i] (monotone in i, so a predicate and a sum).
//    ka is block-uniform: at exact widths a switch picks a body in which
//    ka, and so every index of the scan, is a constant.  The window is
//    summed as it lies, in ascending order of value.
//  * Exact distance ties.  Which of the values lying exactly as far from c
//    as the window's edge are kept is decided by worker index (the stable
//    argsort's rule: lower index kept).  When the window's farthest value
//    inside is as far as its nearest value outside (and that distance is
//    not 0), the thread reads its column again in worker order, keeps
//    every value nearer than that distance and the tied ones of lowest
//    worker index, sorts the kept keys with the same network and sums the
//    first ka.  Two different values can lie equally far from c after
//    fp32 rounding even on one side of it, so this path takes every such
//    case, not only c - D against c + D.  On normal fp32 data it is rare
//    (tests/test_torch_coord_window.py replays the algorithm on the CPU).
//  * All inactive.  W_a is clamped to 1 and ka = 1; the stable argsort of
//    all-+inf distances keeps worker 0, so MeaMed and Phocas return
//    worker 0's raw value.
//
// Summation order.  The trimmed mean sums the sorted middle in ascending
// order, sequentially in fp32, then divides by the count; MeaMed and Phocas
// sum their kept values in ascending order of value the same way.  The
// plain version (kernels/coord_stats/ref.py) uses the same order, so the
// two agree bit for bit, and Phocas (whose center is a trimmed mean) keeps
// the same values in both when two values lie almost equally far from it.
//
// Registers: 2R values at exact widths (62 at R = 15, no spill); the padded
// widths 64 and 128 spill (ptxas -v, chip_smoke.py's build phase).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_networks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWorkers = 128;
constexpr int kMaxExact = 16;
constexpr bool kPrefetch = true;    // launch/coord_probe.py: faster
constexpr int kPrefetchFrom = 7;
enum Op { kMedian = 0, kTrimmedMean = 1, kMeamed = 2, kPhocas = 3 };

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  const unsigned int bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(bits << 16);
}

// s[idx] for a runtime idx, keeping s in registers.
template <int P>
__device__ __forceinline__ float at(const float (&s)[P], int idx) {
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) r = (i == idx) ? s[i] : r;
  return r;
}

// The block-uniform facts of a launch.
template <int P>
struct Column {
  const long long* off;          // row offsets (elements), shared memory
  unsigned int act[(P + 31) / 32];
  int R;
  __device__ __forceinline__ bool active(int i) const {
    return (P <= kMaxExact || i < R) && ((act[i / 32] >> (i % 32)) & 1u);
  }
  // v[i] = X[worker i, col] for active workers, +inf (no load) otherwise.
  template <typename T>
  __device__ __forceinline__ void load(float (&v)[P], const T* x,
                                       long long col) const {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = active(i) ? load1(x + off[i] + col) : inf_f();
  }
};

// For the window s[lo, lo + ka): `far` is its largest distance to c, and
// `tie` says whether a value outside lies exactly that far (at a distance
// other than 0), so that worker indices decide what is kept.
__device__ __forceinline__ void window_edge(float c, float in_lo,
                                            float in_hi, float out_lo,
                                            float out_hi, float& far,
                                            bool& tie) {
  far = fmaxf(fabsf(in_lo - c), fabsf(in_hi - c));
  const float near = fminf(fabsf(out_lo - c), fabsf(out_hi - c));
  tie = !(far < near || far == 0.f);
}

// The sum of the KA values nearest c at an exact width, ascending: lo
// lies in [0, P - KA], and every index below is a constant.
template <int P, int KA>
__device__ __forceinline__ float window_sum(const float (&s)[P], float c,
                                             float& far, bool& tie) {
  constexpr int D = P - KA;
  int lo = 0;
  bool run = true;
  float in_lo = s[0], in_hi = s[KA - 1], out_lo = inf_f();
  float out_hi = D > 0 ? s[D > 0 ? KA : 0] : inf_f();
#pragma unroll
  for (int i = 0; i < D; ++i) {
    run = run && (s[i + KA] - c < c - s[i]);
    if (run) {
      lo = i + 1;
      in_lo = s[i + 1];
      in_hi = s[i + KA];
      out_lo = s[i];
      out_hi = i + 1 < D ? s[i + 1 < D ? i + KA + 1 : 0] : inf_f();
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i >= lo && i < lo + KA) acc += s[i];
  window_edge(c, in_lo, in_hi, out_lo, out_hi, far, tie);
  return acc;
}

// The same with a runtime ka (padded widths): the drop pointer moves over
// at most W_a - ka positions.
template <int P>
__device__ __forceinline__ float window_sum_rt(const float (&s)[P], float c,
                                                int ka, int wa, float& far,
                                                bool& tie) {
  int lo = 0;
#pragma unroll 1
  while (lo < wa - ka && at<P>(s, lo + ka) - c < c - at<P>(s, lo)) ++lo;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i >= lo && i < lo + ka) acc += s[i];
  window_edge(c, at<P>(s, lo), at<P>(s, lo + ka - 1),
              lo > 0 ? at<P>(s, lo - 1) : inf_f(),
              lo + ka < P ? at<P>(s, lo + ka) : inf_f(), far, tie);
  return acc;
}

// The tie path: from the column in worker order, every value nearer than
// `far` and the values exactly `far` away of lowest worker index, ka in
// all, summed in ascending order.
template <int P, typename T>
__device__ __forceinline__ float kept_sum_by_worker(const Column<P>& cl,
                                                     const T* x,
                                                     long long col, float c,
                                                     float far, int ka) {
  float k[P];
  cl.load(k, x, col);
  int need = ka;
#pragma unroll
  for (int w = 0; w < P; ++w) need -= fabsf(k[w] - c) < far ? 1 : 0;
  int seen = 0;
#pragma unroll
  for (int w = 0; w < P; ++w) {
    const float d = fabsf(k[w] - c);
    const bool tied = d == far;
    const bool keep = d < far || (tied && seen < need);
    seen += tied ? 1 : 0;
    k[w] = keep ? k[w] : inf_f();
  }
  sort_net(k);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < ka) acc += k[i];
  return acc;
}

#define WINDOW_CASE(K)                                              \
  case K:                                                           \
    if constexpr (K <= P) r = window_sum<P, K>(s, center, far, tie); \
    break;
#define MEDIAN_CASE(K)                                                   \
  case K:                                                                \
    if constexpr (K <= P) center = (s[(K - 1) / 2] + s[K / 2]) * 0.5f;  \
    break;
#define CASES_1_TO_16(M)                                                 \
  M(1) M(2) M(3) M(4) M(5) M(6) M(7) M(8) M(9) M(10) M(11) M(12) M(13)  \
  M(14) M(15) M(16)

// Launch bounds: at the exact widths the kernel is compiled as for blocks
// of up to 1024 threads (a 64-register ceiling, which 2R <= 32 values and
// the rest fit); told 256, ptxas spilled a few bytes at some widths to
// reach 32 or 48 registers, and told 256 with 1 block an SM it took up to
// 128 registers and ran ~20 % slower.  Padded widths keep 256 (up to 255
// registers).
template <int P, typename T>
__global__ void __launch_bounds__(P <= kMaxExact ? 1024 : kThreads)
coord_stats_kernel(const T* __restrict__ x, long long ld,
                   const int* __restrict__ rows, int R, long long n, int op,
                   int f, const float* __restrict__ mask,
                   float* __restrict__ out) {
  __shared__ long long s_off[P];
  __shared__ int s_act[P];
  __shared__ int s_count;
  if (threadIdx.x < P) {
    const int i = threadIdx.x;
    const bool real = i < R;
    s_off[i] = real ? static_cast<long long>(rows ? rows[i] : i) * ld : 0;
    s_act[i] = real && (mask == nullptr || mask[i] != 0.f);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int i = 0; i < P; ++i) c += s_act[i];
    s_count = c;
  }
  __syncthreads();

  Column<P> cl;
  cl.off = s_off;
  cl.R = R;
#pragma unroll
  for (int w = 0; w < (P + 31) / 32; ++w) cl.act[w] = 0u;
#pragma unroll
  for (int i = 0; i < P; ++i) cl.act[i / 32] |= (s_act[i] ? 1u : 0u) << (i % 32);

  const bool none_active = s_count == 0;
  const int wa = none_active ? 1 : s_count;
  const int kt = min(f, (wa - 1) / 2);
  const int ka = max(wa - f, 1);
  const int cnt = max(wa - 2 * kt, 1);
  const bool nearest = op == kMeamed || op == kPhocas;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  constexpr bool prefetch = kPrefetch && P >= kPrefetchFrom;
  long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float nxt[P];
  if (prefetch && col < n) cl.load(nxt, x, col);
  for (; col < n; col += step) {
    float s[P];
    if (prefetch) {
#pragma unroll
      for (int i = 0; i < P; ++i) s[i] = nxt[i];
      if (col + step < n) cl.load(nxt, x, col + step);
    } else {
      cl.load(s, x, col);
    }
    sort_net(s);

    float center;
    if (op == kMedian || op == kMeamed) {
      if constexpr (P <= kMaxExact) {
        center = 0.f;
        switch (wa) {                    // block-uniform: no runtime index
          CASES_1_TO_16(MEDIAN_CASE)
          default: break;
        }
      } else {
        center = (at<P>(s, (wa - 1) / 2) + at<P>(s, wa / 2)) * 0.5f;
      }
    } else {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (i >= kt && i < wa - kt) acc += s[i];
      center = acc / static_cast<float>(cnt);
    }
    float r = center;
    if (nearest) {
      float far = 0.f;
      bool tie = false;
      if constexpr (P <= kMaxExact) {
        switch (ka) {
          CASES_1_TO_16(WINDOW_CASE)
          default: break;
        }
      } else {
        r = window_sum_rt<P>(s, center, ka, wa, far, tie);
      }
      if (tie && !none_active)
        r = kept_sum_by_worker<P, T>(cl, x, col, center, far, ka);
      r = none_active ? load1(x + s_off[0] + col) : r / static_cast<float>(ka);
    }
    out[col] = r;
  }
}

#undef CASES_1_TO_16
#undef MEDIAN_CASE
#undef WINDOW_CASE

template <int P>
int launch_p(const void* x, int dtype, long long ld, const int* rows, int R,
             long long n, int op, int f, const float* mask, float* out,
             unsigned int blocks, cudaStream_t s) {
  if (dtype == 0) {
    coord_stats_kernel<P, float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), ld, rows, R, n, op, f, mask, out);
  } else if (dtype == 1) {
    coord_stats_kernel<P, __nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ld, rows, R, n, op, f, mask,
        out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const void*, int, long long, const int*, int,
                         long long, int, int, const float*, float*,
                         unsigned int, cudaStream_t);

constexpr LaunchFn kExact[kMaxExact + 1] = {
    nullptr,      launch_p<1>,  launch_p<2>,  launch_p<3>,  launch_p<4>,
    launch_p<5>,  launch_p<6>,  launch_p<7>,  launch_p<8>,  launch_p<9>,
    launch_p<10>, launch_p<11>, launch_p<12>, launch_p<13>, launch_p<14>,
    launch_p<15>, launch_p<16>};

}  // namespace

// x: (W, n) with row stride ld (elements), dtype 0 = fp32, 1 = bf16.
// rows: null (workers are rows 0..R-1) or R int32 row indices into x.
// mask: null or R floats (0 = inactive).  op: 0 median, 1 trimmed mean,
// 2 meamed, 3 phocas.  out: n fp32.  Returns cudaGetLastError().
extern "C" int coord_stats_launch(const void* x, int dtype, long long ld,
                                  const int* rows, int R, long long n, int op,
                                  int f, const float* mask, float* out,
                                  int max_blocks, void* stream) {
  if (R < 1 || R > kMaxWorkers || n < 1 || op < 0 || op > 3 || f < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long want = (n + kThreads - 1) / kThreads;
  if (want > max_blocks) want = max_blocks;
  const unsigned int blocks = static_cast<unsigned int>(want < 1 ? 1 : want);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= kMaxExact)
    return kExact[R](x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  if (R <= 32) return launch_p<32>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  if (R <= 64) return launch_p<64>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  return launch_p<128>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
}
