// Gram kernels for Hopper (sm_90a): one device body, two launch entries.
//
// tree_gram_launch replaces src/repro/kernels/gram/kernel.py::
// tree_gram_pallas (kernel.py:91, body _tree_gram_kernel :74):
// K = scale * X_S X_S^T for the worker-major (W, N) gradient buffer, fp32
// or bf16, read in place through a row stride; X_S is the set of kept
// block_n-wide chunks of repro_torch.kernels.gram.ref.chunk_schedule
// (chunk j starts at column j * stride * block_n).  Only kept chunks are
// read, the ragged last chunk and any W are masked here, and no padded
// copy of X is ever made.
//
// gram_launch replaces gram_pallas (kernel.py:51, body _gram_kernel :35):
// K = G^T G for one (n, p) matrix G read through two arbitrary element
// strides (stride_n, stride_p).  The looped tree Gram
// (tree_gram(fused=False)) calls it once per leaf on a transposed, strided
// view of the (W, N) buffer: p = W workers, stride_p = the buffer's row
// stride, stride_n = the sketch stride.  So the TPU wrapper's padded copy
// (p to 128 lanes, n to block_n) and the JAX path's strided-slice copy
// never exist here.
//
// Both are one walk: K[i, j] = scale * sum_t G[t, i] G[t, j] over the
// logical rows t = c * span + o of chunks c < chunks (o < block_n,
// t < n), G[t, i] at x + i * ld + t * sn.  The tree Gram is the walk on
// X^T (ld = X's row stride, sn = 1, span = stride * block_n); the
// per-matrix Gram is the walk with span = block_n and scale 1.  With
// round_bf16 (fp32 input only) every element is rounded to bf16 in
// registers before the product, which is gram_dtype="bfloat16".  Output
// is (p, p) fp32.
//
// Bound.  Each element read is used in about (p + 1) / 2 multiply-adds: at
// p = 15, 8 FMA per 4-byte load, ~4 FLOP per byte, under the card's fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B).  So both entries are
// bound by bytes: the kept elements times their itemsize, read once.  Over
// all the leaves of a model the looped Gram moves the same bytes as the
// fused one.  With sn > 1 the reads of a warp are strided, so each fetched
// 32-byte sector carries fewer kept elements; the bound still counts the
// kept bytes only.  fp32 inputs use CUDA-core FMAs, never TF32.
//
// Design (simple and correct first).  The TPU kernels carry the sum in
// one output block across a sequential grid; Hopper blocks run in no
// order, so this is split-K in two passes with no atomics:
//   1. grid (splits, items): each block owns the chunks split,
//      split + splits, split + 2 splits, ... and one output item: a 16x16
//      diagonal tile of K (upper triangle, 136 sums) or half of an
//      off-diagonal tile (8x16).  Each thread walks whole rows t, keeps its
//      item's sums in registers, and the block reduces them (warp
//      shuffles, then warps in order) into partial[split].  Consecutive
//      threads read consecutive t, so at sn = 1 every load of a warp is
//      coalesced, and the blocks in flight read neighbouring chunks.
//   2. one small launch sums partial[0..splits) in order, applies scale
//      and mirrors the triangle.
// The result is bit-identical from run to run.  At p <= 16 (the paper's
// p = 15) there is one item, so the input is read exactly once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;                      // rows of one diagonal tile
constexpr int kHalf = 8;                       // rows of an off-diagonal half
constexpr int kDiagSums = kTile * (kTile + 1) / 2;
constexpr int kOffSums = kHalf * kTile;

template <typename T, bool kRoundBf16>
__device__ __forceinline__ float load_f32(const T* p);

template <>
__device__ __forceinline__ float load_f32<float, false>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load_f32<float, true>(const float* p) {
  // gram_dtype="bfloat16" on an fp32 input: round to bf16 in registers,
  // the same values a cast copy would hold.
  return __bfloat162float(__float2bfloat16(__ldg(p)));
}

template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16, false>(
    const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// The walk: logical rows [t0, t0 + len) of chunk c.
struct Walk {
  long long ld, sn, n, span;
  int chunks, block_n;
  __device__ __forceinline__ void chunk(int c, long long* t0, int* len) const {
    *t0 = static_cast<long long>(c) * span;
    const long long rest = n - *t0;
    *len = rest < block_n ? static_cast<int>(rest) : block_n;
  }
};

// Sums each thread's `acc` over the block in a fixed order (shuffle tree
// inside each warp, then warps in order); the totals land in the shared
// array `out` (kCount floats).
template <int kCount>
__device__ __forceinline__ void block_sum(float (&acc)[kCount], float* red,
                                          float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kCount; ++a) {
    float v = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * kCount + a] = v;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < kCount; a += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * kCount + a];
    out[a] = s;
  }
  __syncthreads();
}

// Diagonal tile `blockIdx.y`: rows/cols [r0, r0 + 16) of K, upper triangle.
template <typename T, bool kRoundBf16>
__global__ void __launch_bounds__(kThreads)
gram_diag(const T* __restrict__ x, Walk wk, int w,
          float* __restrict__ partial) {
  __shared__ float red[kWarps * kDiagSums];
  __shared__ float tot[kDiagSums];
  const int r0 = blockIdx.y * kTile;
  const int split = blockIdx.x;
  const int splits = gridDim.x;

  float acc[kDiagSums];
#pragma unroll
  for (int a = 0; a < kDiagSums; ++a) acc[a] = 0.f;

  const T* base = x + static_cast<long long>(r0) * wk.ld;
  for (int c = split; c < wk.chunks; c += splits) {
    long long t0;
    int len;
    wk.chunk(c, &t0, &len);
    for (int o = threadIdx.x; o < len; o += kThreads) {
      const T* p = base + (t0 + o) * wk.sn;
      float v[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        v[r] = (r0 + r < w) ? load_f32<T, kRoundBf16>(p + r * wk.ld) : 0.f;
      int a = 0;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int j = i; j < kTile; ++j) {
          acc[a] = fmaf(v[i], v[j], acc[a]);
          ++a;
        }
      }
    }
  }

  block_sum<kDiagSums>(acc, red, tot);
  float* dst = partial + static_cast<long long>(split) * w * w;
  for (int a = threadIdx.x; a < kDiagSums; a += kThreads) {
    // a -> (i, j), i <= j, row-major over the upper triangle
    int i = 0, rem = a;
    while (rem >= kTile - i) { rem -= kTile - i; ++i; }
    const int j = i + rem;
    if (r0 + j < w) dst[(r0 + i) * w + (r0 + j)] = tot[a];
  }
}

// Off-diagonal item: blockIdx.y = 2 * pair + half, pair enumerating the
// tile pairs (ti < tj) row by row; rows [ra, ra + 8) x cols [rb, rb + 16).
template <typename T, bool kRoundBf16>
__global__ void __launch_bounds__(kThreads)
gram_offdiag(const T* __restrict__ x, Walk wk, int w, int tiles,
             float* __restrict__ partial) {
  __shared__ float red[kWarps * kOffSums];
  __shared__ float tot[kOffSums];
  int pair = blockIdx.y >> 1;
  const int half = blockIdx.y & 1;
  int ti = 0;
  while (pair >= tiles - 1 - ti) { pair -= tiles - 1 - ti; ++ti; }
  const int tj = ti + 1 + pair;
  const int ra = ti * kTile + half * kHalf;
  const int rb = tj * kTile;
  const int split = blockIdx.x;
  const int splits = gridDim.x;

  float acc[kOffSums];
#pragma unroll
  for (int a = 0; a < kOffSums; ++a) acc[a] = 0.f;

  const T* base_a = x + static_cast<long long>(ra) * wk.ld;
  const T* base_b = x + static_cast<long long>(rb) * wk.ld;
  for (int c = split; c < wk.chunks; c += splits) {
    long long t0;
    int len;
    wk.chunk(c, &t0, &len);
    for (int o = threadIdx.x; o < len; o += kThreads) {
      const long long at = (t0 + o) * wk.sn;
      float va[kHalf], vb[kTile];
#pragma unroll
      for (int r = 0; r < kHalf; ++r)
        va[r] = (ra + r < w) ? load_f32<T, kRoundBf16>(base_a + r * wk.ld + at) : 0.f;
#pragma unroll
      for (int r = 0; r < kTile; ++r)
        vb[r] = (rb + r < w) ? load_f32<T, kRoundBf16>(base_b + r * wk.ld + at) : 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          acc[i * kTile + j] = fmaf(va[i], vb[j], acc[i * kTile + j]);
      }
    }
  }

  block_sum<kOffSums>(acc, red, tot);
  float* dst = partial + static_cast<long long>(split) * w * w;
  for (int a = threadIdx.x; a < kOffSums; a += kThreads) {
    const int i = a / kTile, j = a % kTile;
    if (ra + i < w && rb + j < w) dst[(ra + i) * w + (rb + j)] = tot[a];
  }
}

// K[i, j] = scale * sum_s partial[s, min(i,j), max(i,j)], s in order.
__global__ void gram_reduce(const float* __restrict__ partial, int splits,
                            int w, float scale, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= w * w) return;
  const int i = idx / w, j = idx % w;
  const int a = i < j ? i : j, b = i < j ? j : i;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(static_cast<long long>(k) * w + a) * w + b];
  out[idx] = s * scale;
}

template <typename T, bool kRoundBf16>
void launch_items(const void* x, const Walk& wk, int w, int splits,
                  float* partial, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int tiles = (w + kTile - 1) / kTile;
  gram_diag<T, kRoundBf16><<<dim3(splits, tiles), kThreads, 0, stream>>>(
      xt, wk, w, partial);
  if (tiles > 1) {
    gram_offdiag<T, kRoundBf16>
        <<<dim3(splits, tiles * (tiles - 1)), kThreads, 0, stream>>>(
            xt, wk, w, tiles, partial);
  }
}

int run(const void* x, int dtype, int round_bf16, const Walk& wk, int w,
        int splits, float scale, float* partial, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && round_bf16) {
    launch_items<float, true>(x, wk, w, splits, partial, s);
  } else if (dtype == 0) {
    launch_items<float, false>(x, wk, w, splits, partial, s);
  } else if (dtype == 1) {
    launch_items<__nv_bfloat16, false>(x, wk, w, splits, partial, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int total = w * w;
  gram_reduce<<<(total + 255) / 256, 256, 0, s>>>(partial, splits, w, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries: dtype 0 = fp32, 1 = bf16; round_bf16 (fp32 only) rounds
// every element to bf16 before the product; partial is (splits, w, w) fp32
// scratch and out (w, w) fp32.  They return cudaGetLastError() after the
// launches.

// X (w, n) with row stride ld and unit column stride; kept chunks of
// block_n columns, chunk c starting at column c * chunk_step.
extern "C" int tree_gram_launch(const void* x, int dtype, int round_bf16,
                                long long ld, long long n, int w, int kept,
                                int block_n, long long chunk_step, int splits,
                                float scale, float* partial, float* out,
                                void* stream) {
  const Walk wk{ld, 1, n, chunk_step, kept, block_n};
  return run(x, dtype, round_bf16, wk, w, splits, scale, partial, out, stream);
}

// G (n, p), G[i, j] at g + i * sn + j * sp; chunks of block_n rows.
extern "C" int gram_launch(const void* g, int dtype, int round_bf16,
                           long long sn, long long sp, long long n, int p,
                           int chunks, int block_n, int splits,
                           float* partial, float* out, void* stream) {
  const Walk wk{sp, sn, n, block_n, chunks, block_n};
  return run(g, dtype, round_bf16, wk, p, splits, 1.0f, partial, out, stream);
}
