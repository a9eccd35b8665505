// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attn/kernel.py::flash_attn_pallas
// (_flash_kernel, kernel.py:31).  q (B, H, Sq, D), k/v (B, KV, Sk, D) with
// H % KV == 0, fp32 or bf16, any strides with a unit stride along D; out
// (B, H, Sq, D) in q's dtype.  Query head h reads KV head h / (H / KV) in
// place, so grouped-query attention needs no repeated-KV copy.  Queries
// are aligned to the tail of the keys: query i sits at absolute position
// i + Sk - Sq.  Masks: k-padding, q-padding, causal (col <= row) and the
// sliding window (col > row - window).  Masked scores take the finite
// NEG = -1e30 and the probabilities are multiplied by the mask, so a fully
// masked row (the first rows when Sq > Sk under causal masking) gives 0,
// not NaN; the output is acc / l where l > 0, else 0.  Scale (default
// D^-0.5) is applied to q in fp32 before the product, as kernel.py:42
// does.  The running max, normaliser and accumulator are fp32.
//
// Bound.  The work is 4 * D multiply-adds per (query, key) pair kept by
// the mask (2 * D for q.k, 2 * D for p.v).  At the serving path's prefill
// (S = 2048, D = 64) that is ~128 FLOP per byte of q, k, v and out: far
// above the card's ridge, so the kernel is bound by operations.  The
// card's floor is the bf16 tensor-core rate (989 TFLOP/s); this first
// kernel uses fp32 FMAs on the CUDA cores (67 TFLOP/s), so its own floor
// is ~15x that.  Tensor-core MMA (mma.sync / wgmma) is later work.
//
// Design (simple and correct first).  The TPU kernel walks a sequential
// (bh, q-block, k-block) grid and carries m, l and o in its output VMEM
// blocks.  Here one thread block owns one (b, h, 64-query tile) and loops
// over the key tiles itself, so nothing carries across blocks:
//   - Q is staged once in shared memory, scaled, in fp32; each key tile's
//     K and V are staged in fp32 (rows padded by one float, so the strided
//     reads of the inner loops hit 32 different banks);
//   - 256 threads as 16 x 16: thread (ty, tx) owns query rows ty + 16 i
//     (i < 4) and key columns tx + 16 j of the score tile, and output
//     columns tx + 16 c; the row max and row sum are reduced over the 16
//     tx lanes with shuffles, so every thread holds its rows' m and l;
//   - key tiles wholly outside the causal / window band are skipped (a
//     fully masked tile leaves m, l and acc unchanged, so skipping is
//     exact), and the heaviest causal query tiles are launched first.
// Key tiles are 64 keys for D <= 128 and 32 for D = 256, which keeps the
// shared memory of a block at 65-140 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;          // 16 x 16
constexpr int kBQ = 64;                // query rows of a block
constexpr int kRows = kBQ / 16;        // query rows of a thread

template <int D>
struct Tile {
  static constexpr int kBK = D <= 128 ? 64 : 32;    // keys of a tile
  static constexpr int kLD = D + 1;                 // padded row of Qs, Ks
  static constexpr int kLP = kBK + 1;               // padded row of Ps
  static constexpr size_t kSmemFloats =
      kBQ * kLD + kBK * kLD + kBK * D + kBQ * kLP;
};

struct Strides {
  long long b, h, s;                   // in elements; unit stride along D
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
          Strides vs, Strides os, int group, int seq_q, int seq_k,
          float scale, int causal, int has_window, int window) {
  constexpr int BK = Tile<D>::kBK;
  constexpr int LD = Tile<D>::kLD;
  constexpr int LP = Tile<D>::kLP;
  constexpr int kCols = BK / 16;       // score columns of a thread
  constexpr int kDc = D / 16;          // output columns of a thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;           // [BK][LD]
  float* Vs = Ks + BK * LD;            // [BK][D]
  float* Ps = Vs + BK * D;             // [kBQ][LP]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = seq_k - seq_q;               // absolute row = i + off

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int i = q0 + r;
    Qs[r * LD + d] = i < seq_q ? to_f32(qb[i * qs.s + d]) * scale : 0.f;
  }

  // Key tiles that can hold an unmasked key for some row of this tile.
  const int first_row = q0 + off;
  const int last_row = min(q0 + kBQ, seq_q) - 1 + off;
  int kt_end = (seq_k + BK - 1) / BK;
  if (causal) kt_end = last_row < 0 ? 0 : min(kt_end, last_row / BK + 1);
  int kt_begin = 0;
  if (has_window) {
    const int lo = first_row - window + 1;     // lowest key any row keeps
    if (lo > 0) kt_begin = lo / BK;
  }

  float m[kRows], l[kRows], acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // Qs staged; last tile's Ps, Vs read
    for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int j = k0 + c;
      const bool in = j < seq_k;
      Ks[c * LD + d] = in ? to_f32(kb[j * ks.s + d]) : 0.f;
      Vs[c * D + d] = in ? to_f32(vb[j * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i + off;
      float keep[kCols];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < seq_k && row < seq_k;  // k-padding, q-padding
        if (causal) ok = ok && col <= row;
        if (has_window) ok = ok && col > row - window;
        keep[j] = ok ? 1.f : 0.f;
        s[i][j] = ok ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);  // <= 1, finite
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_cur) * keep[j];
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, sh);
      l[i] = l[i] * alpha + rs;
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int dc = 0; dc < kDc; ++dc) {
        const float vv = Vs[c * D + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= seq_q) continue;
    const bool any = l[i] > 0.f;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dc = 0; dc < kDc; ++dc)
      store(ob + qi * os.s + tx + 16 * dc, any ? acc[i][dc] / den : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int group, int seq_q, int seq_k, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int has_window,
           int window, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float) * Tile<D>::kSmemFloats);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((seq_q + kBQ - 1) / kBQ, H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, group,
      seq_q, seq_k, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               int B, int H, int group, int seq_q, int seq_k, Strides qs,
               Strides ks, Strides vs, Strides os, float scale, int causal,
               int has_window, int window, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, group, seq_q, seq_k, qs, ks, vs,
                           os, scale, causal, has_window, window, s);
    case 96:
      return launch<T, 96>(q, k, v, o, B, H, group, seq_q, seq_k, qs, ks, vs,
                           os, scale, causal, has_window, window, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, group, seq_q, seq_k, qs, ks,
                            vs, os, scale, causal, has_window, window, s);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, group, seq_q, seq_k, qs, ks,
                            vs, os, scale, causal, has_window, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and out alike).  d: 64, 96, 128 or
// 256.  Strides are in elements: (batch, head, sequence) for each tensor,
// unit along d.  group = H / KV.  has_window = 0 ignores window.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int d,
    int B, int H, int group, int seq_q, int seq_k, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale, int causal,
    int has_window, int window, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, B, H, group, seq_q, seq_k, qs, ks,
                             vs, os, scale, causal, has_window, window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, B, H, group, seq_q,
                                     seq_k, qs, ks, vs, os, scale, causal,
                                     has_window, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
