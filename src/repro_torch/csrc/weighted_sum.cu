// Weighted combine for Hopper (sm_90a):  d[n] = sum_w c[w] * X[w, n].
//
// Replaces src/repro/kernels/weighted_sum/kernel.py::weighted_sum_pallas
// (_wsum_kernel), the FA update of Algorithm 1, line 6.  X is the
// worker-major (W, N) gradient buffer, fp32 or bf16, read in place through
// a row stride; c is fp32 (W,).  Each output is accumulated in fp32 in the
// fixed order w = 0 .. W-1 and written in X's dtype.  One launch covers
// the whole N.
//
// Bound.  A pure streaming reduction over a tiny axis: it reads
// W * N * itemsize and writes N * itemsize, with 2 FLOP per element read,
// so it is bound by bytes.  Each thread owns 4 consecutive columns and
// loads them as one 16-byte (fp32) or 8-byte (bf16) vector per worker, so
// a warp reads 512 (256) contiguous bytes of a row per load.  Buffers or
// row strides that are not aligned for that take a one-column-per-thread
// path with the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_bits_to_f32(unsigned int bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_bits_to_f32(q.x & 0xffffu);
  v[1] = bf16_bits_to_f32(q.x >> 16);
  v[2] = bf16_bits_to_f32(q.y & 0xffffu);
  v[3] = bf16_bits_to_f32(q.y >> 16);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf16_bits_to_f32(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ void store4(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&a)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned int*>(&lo);
  q.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

// Columns [0, 4 * n4): four per thread, vector loads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_sum_vec4(const T* __restrict__ x, long long ld, long long n4, int w,
                  const float* __restrict__ c, T* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       q < n4; q += step) {
    const long long col = 4 * q;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < w; ++k) {
      const float ck = __ldg(c + k);
      float v[4];
      load4(x + k * ld + col, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(ck, v[e], acc[e]);
    }
    store4(out + col, acc);
  }
}

// Columns [col0, n): one per thread (unaligned buffers and the ragged tail).
template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_sum_scalar(const T* __restrict__ x, long long ld, long long col0,
                    long long n, int w, const float* __restrict__ c,
                    T* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long col = col0 + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       col < n; col += step) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < w; ++k) acc = fmaf(__ldg(c + k), load1(x + k * ld + col), acc);
    store1(out + col, acc);
  }
}

unsigned int grid_for(long long items, int max_blocks) {
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}

template <typename T>
void launch(const void* x, long long ld, long long n, int w, const float* c,
            void* out, int max_blocks, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0 && ld % 4 == 0;
  long long done = 0;
  if (vec && n >= 4) {
    const long long n4 = n / 4;
    weighted_sum_vec4<T><<<grid_for(n4, max_blocks), kThreads, 0, stream>>>(
        xt, ld, n4, w, c, ot);
    done = 4 * n4;
  }
  if (done < n) {
    weighted_sum_scalar<T><<<grid_for(n - done, max_blocks), kThreads, 0, stream>>>(
        xt, ld, done, n, w, c, ot);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (X and out share it).  c: fp32 (w,).
// Returns cudaGetLastError() after the launches.
extern "C" int weighted_sum_launch(const void* x, int dtype, long long ld,
                                   long long n, int w, const float* c,
                                   void* out, int max_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, ld, n, w, c, out, max_blocks, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, ld, n, w, c, out, max_blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
