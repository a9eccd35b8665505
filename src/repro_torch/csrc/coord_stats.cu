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
// Design.  One thread owns one coordinate (grid-stride loop); a warp reads
// 32 neighbouring columns of one row per load.  The thread sorts its column
// in registers with an odd-even transposition network, padded to the
// template width P (a power of two <= 128) with +inf, the key the JAX
// masked references give inactive workers; inactive workers get +inf too,
// so they sort to the top with the padding.  The round loop is not
// unrolled, the pairs inside a round are: every register index is a
// constant, and a value at a runtime position (W_a) is read with an
// unrolled compare loop, never a[i], which would move the array to local
// memory.  MeaMed and Phocas then sort (|g - center|, g) pairs with the same
// network on the column in worker order.
//
// Stability is part of the result.  A compare-exchange of neighbours swaps
// only on a strict '>', so equal keys never pass each other: the network is
// stable, and on a tie in |g - center| the lower worker index is kept, as
// the stable argsort of the plain version (and jnp.argsort) keeps it.
//
// Summation order.  The trimmed mean sums the sorted middle in ascending
// order, sequentially in fp32, then divides by the count; MeaMed and Phocas
// sum their kept values in ascending distance order the same way.  The
// plain version (kernels/coord_stats/ref.py) uses the same order, so Phocas
// (whose center is a trimmed mean) keeps the same values in both when two
// values lie almost equally far from the center.
//
// Bound.  At W = 15 (P = 16) a coordinate costs 15 loads of 4 bytes and
// one store; the network is P rounds of P/2 compare-exchanges (~120, two
// min/max each), about 2.5x that for the key-value pass.  That is a few
// hundred operations per 64 bytes, so the bound is the bytes at P = 16 and
// the operations from P = 64 on (chip_smoke.py prints both).  Registers:
// P keys, plus P values and P distances for MeaMed / Phocas; P = 128 with
// the key-value pass spills (ptxas -v, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWorkers = 128;
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

// Ascending odd-even transposition sort of keys (P rounds).
template <int P>
__device__ __forceinline__ void sort_keys(float (&k)[P]) {
#pragma unroll 1
  for (int r = 0; r < P / 2; ++r) {
#pragma unroll
    for (int i = 0; i + 1 < P; i += 2) {
      const float a = k[i], b = k[i + 1];
      k[i] = fminf(a, b);
      k[i + 1] = fmaxf(a, b);
    }
#pragma unroll
    for (int i = 1; i + 1 < P; i += 2) {
      const float a = k[i], b = k[i + 1];
      k[i] = fminf(a, b);
      k[i + 1] = fmaxf(a, b);
    }
  }
}

template <int P>
__device__ __forceinline__ void cx_kv(float (&k)[P], float (&v)[P], int i) {
  const bool sw = k[i] > k[i + 1];  // strict: equal keys keep their order
  const float k0 = k[i], k1 = k[i + 1], v0 = v[i], v1 = v[i + 1];
  k[i] = sw ? k1 : k0;
  k[i + 1] = sw ? k0 : k1;
  v[i] = sw ? v1 : v0;
  v[i + 1] = sw ? v0 : v1;
}

// Stable ascending sort of keys k, permuting payload v alike (P rounds).
template <int P>
__device__ __forceinline__ void sort_kv(float (&k)[P], float (&v)[P]) {
#pragma unroll 1
  for (int r = 0; r < P / 2; ++r) {
#pragma unroll
    for (int i = 0; i + 1 < P; i += 2) cx_kv<P>(k, v, i);
#pragma unroll
    for (int i = 1; i + 1 < P; i += 2) cx_kv<P>(k, v, i);
  }
}

template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
coord_stats_kernel(const T* __restrict__ x, long long ld,
                   const int* __restrict__ rows, int R, long long n, int op,
                   int f, const float* __restrict__ mask,
                   float* __restrict__ out) {
  __shared__ long long s_off[P];
  __shared__ int s_act[P];
  __shared__ int s_wa;
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
    s_wa = c < 1 ? 1 : c;
  }
  __syncthreads();

  unsigned int act[(P + 31) / 32];
#pragma unroll
  for (int w = 0; w < (P + 31) / 32; ++w) act[w] = 0u;
#pragma unroll
  for (int i = 0; i < P; ++i) act[i / 32] |= (s_act[i] ? 1u : 0u) << (i % 32);

  const int wa = s_wa;
  const int kt = min(f, (wa - 1) / 2);
  const int ka = max(wa - f, 1);
  const float inf = inf_f();
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long col = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       col < n; col += step) {
    float g[P], s[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      g[i] = (i < R) ? load1(x + s_off[i] + col) : 0.f;
      s[i] = ((act[i / 32] >> (i % 32)) & 1u) ? g[i] : inf;
    }
    sort_keys<P>(s);

    float center;
    if (op == kMedian || op == kMeamed) {
      center = (at<P>(s, (wa - 1) / 2) + at<P>(s, wa / 2)) * 0.5f;
    } else {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) acc += (i >= kt && i < wa - kt) ? s[i] : 0.f;
      center = acc / static_cast<float>(max(wa - 2 * kt, 1));
    }
    float r = center;
    if (op == kMeamed || op == kPhocas) {
      // s is dead: reuse it for the distances of the column in worker order
#pragma unroll
      for (int i = 0; i < P; ++i)
        s[i] = ((act[i / 32] >> (i % 32)) & 1u) ? fabsf(g[i] - center) : inf;
      sort_kv<P>(s, g);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) acc += (i < ka) ? g[i] : 0.f;
      r = acc / static_cast<float>(ka);
    }
    out[col] = r;
  }
}

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
  if (R <= 2) return launch_p<2>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  if (R <= 4) return launch_p<4>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  if (R <= 8) return launch_p<8>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  if (R <= 16) return launch_p<16>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  if (R <= 32) return launch_p<32>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  if (R <= 64) return launch_p<64>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
  return launch_p<128>(x, dtype, ld, rows, R, n, op, f, mask, out, blocks, s);
}
