// Flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attn/kernel.py::flash_attn_pallas
// (kernel.py:83; its body _flash_kernel, kernel.py:31).  q (B, H, Sq, D),
// k/v (B, KV, Sk, D) with H % KV == 0, out (B, H, Sq, D) in q's dtype,
// D in {64, 96, 128, 256}.  Query head h reads KV head h / (H / KV) in
// place, so grouped-query attention needs no repeated-KV copy.  Queries
// are aligned to the tail of the keys: query i sits at absolute position
// i + Sk - Sq.  Masks: k-padding, q-padding, causal (col <= row) and the
// sliding window (col > row - window).  Masked scores take the finite
// NEG = -1e30 and the probabilities are multiplied by the mask, so a row
// that sees no key (the first rows when Sq > Sk under causal masking)
// gives exactly 0, not NaN; the output is acc / l where l > 0, else 0.
// The running max, normaliser and accumulator are fp32.  Both bodies skip
// key tiles wholly outside the causal / window band (a fully masked tile
// leaves m, l and acc unchanged, so skipping is exact) and launch the
// heaviest causal query tiles first; one block owns one (b, h, 64-query
// tile) and loops over the key tiles itself.
//
// Bound.  4 * D FLOP per (query, key) pair kept by the mask (2 * D for
// q.k, 2 * D for p.v): at the serving path's prefill (S = 2048, D = 64)
// ~128 FLOP per byte of q, k, v and out, far above the card's ridge, so
// the function is bound by operations, at the bf16 tensor-core rate
// (989 TFLOP/s).
//
// Two bodies, chosen by dtype (no switch, no fallback between them):
//
// fp32 (dtype 0): flash_fwd<float, D>, fp32 FMAs on the CUDA cores
//   (67 TFLOP/s).  It keeps fp32 accuracy, which TF32 tensor cores would
//   not, and serves the fp32 reduced configuration.  Q is staged once,
//   scaled, in fp32 shared memory and each key tile's K and V likewise
//   (rows padded by one float for conflict-free strided reads); 16 x 16
//   threads each own a 4 x 4 score tile; the row max and sum are reduced
//   over the 16 lanes of a row with shuffles.  Key tiles of 64 (32 at
//   D = 256).
//
// bf16 (dtype 1): flash_fwd_tc<D>, the tensor cores.  One warpgroup (128
//   threads) per block owns 64 query rows; warp w holds rows 16w .. 16w+15
//   of every fragment.
//   - Loads: TMA.  The host encodes three 4-D tensor maps (d, seq, head,
//     batch) per call from the pointers and byte strides; GQA is the head
//     coordinate h / group.  Q's tile is loaded once; K and V tiles (64
//     keys, 32 at D = 256) go through a 2-stage ring, one mbarrier a
//     stage, so the next tile's copy is in flight while this tile's
//     products run.  Tiles land 128-byte swizzled in column blocks of 64
//     (64-byte swizzle in blocks of 32 at D = 96, whose 192-byte rows do
//     not split into 128-byte ones).  TMA zero-fills rows past Sq / Sk;
//     the masks still decide by index.
//   - S = Q K^T: wgmma m64n{BK}k16, A and B from shared memory, both
//     K-major as stored, fp32 accumulators; the scale (times log2 e, for
//     exp2) is applied to the fp32 scores.
//   - Softmax on the accumulator registers; the 4 lanes that share a row
//     reduce its max and sum with shuffles.
//   - O += P V: wgmma with A = P from registers (the score accumulator's
//     layout is the A fragment's, so P never touches shared memory) and
//     B = V from shared memory, MN-major (transposed), one m64n64k16 (n32
//     at D = 96) per column block of V.
//   - P is split into two bf16 values, P_hi = bf16(P) and P_lo =
//     bf16(P - P_hi), and O += P_hi V + P_lo V.  Rounding P once to bf16,
//     as bf16 attention usually does, would put the output up to 6-12
//     times over this port's limit (|o - want| <= 2e-4 + (2e-4 + 2^-8)
//     |want| against the fp32 plain version, which allows the output's one
//     rounding only; tests/test_torch_flash_numerics.py): short causal rows
//     whose few terms nearly cancel.  The split keeps P to ~16 bits for
//     1.5 times the tensor work of one product; q, k and v are bf16
//     already, so exact as operands.  l sums the fp32 P.
//   - Epilogue: o / l rounded to bf16 once, stored from registers.
//   Alignment rule (TMA): q, k and v start on a 16-byte boundary and every
//   stride but d's (unit) is a multiple of 16 bytes, i.e. of 8 elements;
//   the stride of a dimension of size 1 is never read.  The wrapper checks
//   it and raises; it never copies.
//
// Returns cudaGetLastError() after the launch, or 100000 + the CUresult of
// cuTensorMapEncodeTiled if it refuses a tensor map.

#include <cuda.h>          // CUtensorMap and its enums only: the encoder is
                           // fetched at run time, the runtime alone links
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;                // query rows of a block

struct Strides {
  long long b, h, s;                   // in elements; unit stride along D
};

// ---------------------------------------------------------------- fp32 body

constexpr int kThreads = 256;          // 16 x 16
constexpr int kRows = kBQ / 16;        // query rows of a thread

template <int D>
struct Tile {
  static constexpr int kBK = D <= 128 ? 64 : 32;    // keys of a tile
  static constexpr int kLD = D + 1;                 // padded row of Qs, Ks
  static constexpr int kLP = kBK + 1;               // padded row of Ps
  static constexpr size_t kSmemFloats =
      kBQ * kLD + kBK * kLD + kBK * D + kBQ * kLP;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ---------------------------------------------------------------- bf16 body

using bf16 = __nv_bfloat16;
constexpr int kWG = 128;               // one warpgroup owns a block's rows
constexpr int kStages = 2;             // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = 100000;

template <int D>
struct TcTile {
  static constexpr int kBK = D <= 128 ? 64 : 32;        // keys of a tile
  static constexpr int kSwz = D % 64 == 0 ? 128 : 64;   // bytes of a smem row
  static constexpr int kCols = kSwz / 2;                // columns of a block
  static constexpr int kBlocks = D / kCols;             // column blocks
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;          // one K or V tile
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + kStages) + 1024;
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : 2;  // wgmma swizzle
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of a 4-D map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The pair as one 32-bit register: .x (the lower column) in the low half.
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x, x <= 0, in one MUFU instruction (<= 2 ulp; results below 2^-126
// flush to 0, an absolute error under 1.2e-38).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A B for one k16 step: A and B from shared memory, both K-major;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B for one k16 step: A (64 x 16 bf16) from registers in the
// accumulator-shaped fragment, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// P of one key tile as the A fragments of its two bf16 halves: register r
// of k16 step kk holds the score pair 8 kk + 2 r, 8 kk + 2 r + 1.
template <int BK>
struct PFrag {
  uint32_t hi[BK / 16][4], lo[BK / 16][4];
};

struct Masks {
  int seq_k, causal, has_window, window;
};

// One tile's raw fp32 scores -> P, split into ``p``; updates the running
// max m and sum l of the thread's two rows and returns their rescale
// factors in ``alpha``.  ``row`` is the absolute position of the first of
// the two rows, ``col`` the key of the thread's first column; ``edge`` says
// whether any element of the tile may be masked.  Scores become x = s *
// scale * log2 e in place.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], PFrag<BK>& p,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int row, int col,
                                             const Masks& mk,
                                             float scale_log2) {
  constexpr int kS = BK / 2;
  uint32_t keep = ~0u;
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    float x = s[i] * scale_log2;
    if (edge) {
      const int r = row + 8 * ((i >> 1) & 1);
      const int c = col + 8 * (i >> 2) + (i & 1);
      bool ok = c < mk.seq_k && r < mk.seq_k;  // k-padding, q-padding
      if (mk.causal) ok = ok && c <= r;
      if (mk.has_window) ok = ok && c > r - mk.window;
      if (!ok) {
        x = kNeg;
        keep &= ~(1u << i);
      }
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_cur = fmaxf(m[r], mx[r]);
    alpha[r] = fast_exp2(m[r] - m_cur);        // <= 1, finite
    m[r] = m_cur;
  }
  // p = exp2(x - m) * mask; P_hi = bf16(p), P_lo = bf16(p - P_hi).
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kS; i += 2) {
    const int r = (i >> 1) & 1;
    const float p0 = (keep >> i) & 1u ? fast_exp2(s[i] - m[r]) : 0.f;
    const float p1 = (keep >> (i + 1)) & 1u ? fast_exp2(s[i + 1] - m[r])
                                            : 0.f;
    rs[r] += p0 + p1;
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
    const float2 hf = __bfloat1622float2(hi);
    p.hi[i >> 3][(i >> 1) & 3] = bits(hi);
    p.lo[i >> 3][(i >> 1) & 3] =
        bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = l[r] * alpha[r] + rs[r];
  }
}

// S = Q K^T for one key tile (issued, not waited for).
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[TcTile<D>::kBK / 2],
                                        uint32_t q_s, uint32_t ks) {
  using T = TcTile<D>;
  constexpr int kSteps = T::kCols / 16;       // k16 steps in a column block
  constexpr uint32_t kAtom = 8 * T::kSwz;     // 8 swizzled rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // column block kk / kSteps, 32 bytes a step along its swizzled rows
    const uint32_t c = kk / kSteps, step = (kk % kSteps) * 32;
    wgmma_ss(s,
             smem_desc(q_s + c * kBQ * T::kSwz + step, 16, kAtom, T::kLayout),
             smem_desc(ks + c * T::kBK * T::kSwz + step, 16, kAtom,
                       T::kLayout),
             kk > 0);
  }
}

// O += P_hi V + P_lo V for one key tile (issued, not waited for).  V's
// k16 step kk is 16 rows of the tile; one instruction per column block,
// whose width is one swizzle row, so the leading byte offset is never read
// (given the stride's value anyway).
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc)[TcTile<D>::kBlocks][TcTile<D>::kCols / 2],
    const PFrag<TcTile<D>::kBK>& p, uint32_t vs) {
  using T = TcTile<D>;
  constexpr uint32_t kAtom = 8 * T::kSwz;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int kk = 0; kk < T::kBK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < T::kBlocks; ++c)
        wgmma_rs(acc[c], half == 0 ? p.hi[kk] : p.lo[kk],
                 smem_desc(vs + c * T::kBK * T::kSwz + kk * 16 * T::kSwz,
                           kAtom, kAtom, T::kLayout));
}

// K and V tiles ``kt`` into a ring stage (thread 0 only).
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t ks,
                                        uint32_t vs, uint32_t bar, int kt,
                                        int kvh, int b) {
  using T = TcTile<D>;
  mbar_expect_tx(bar, 2 * T::kKVBytes);
#pragma unroll
  for (int c = 0; c < T::kBlocks; ++c) {
    tma_load(ks + c * T::kBK * T::kSwz, tk, bar, c * T::kCols, kt * T::kBK,
             kvh, b);
    tma_load(vs + c * T::kBK * T::kSwz, tv, bar, c * T::kCols, kt * T::kBK,
             kvh, b);
  }
}

template <int D>
__global__ void __launch_bounds__(kWG, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
             Strides os, int group, int seq_q, int seq_k, float scale_log2,
             int causal, int has_window, int window) {
  using T = TcTile<D>;
  constexpr int BK = T::kBK, kSwz = T::kSwz, kCols = T::kCols;
  constexpr int kBlocks = T::kBlocks;
  constexpr int kO = kCols / 2;        // output registers, per column block

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The swizzle repeats every 8 rows, so tiles start 1024-byte aligned.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                  // Q: column blocks of 64 rows
  const uint32_t k_s = base + T::kQBytes;     // then the K and V stages
  const uint32_t v_s = k_s + kStages * T::kKVBytes;
  const uint32_t bar_q = base + T::kBarOff;   // then one barrier a stage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int q0 = qt * kBQ;
  const int off = seq_k - seq_q;               // absolute row = i + off
  const Masks mk{seq_k, causal, has_window, window};

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
  const int n = max(kt_end - kt_begin, 0);

  if (tid == 0 && n > 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_q + 8 * (1 + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
    for (int c = 0; c < kBlocks; ++c)
      tma_load(q_s + c * kBQ * kSwz, &tq, bar_q, c * kCols, q0, h, b);
    for (int s = 0; s < kStages && s < n; ++s)
      load_kv<D>(&tk, &tv, k_s + s * T::kKVBytes, v_s + s * T::kKVBytes,
                 bar_q + 8 * (1 + s), kt_begin + s, kvh, b);
  }
  __syncthreads();

  // Thread (warp, lane) holds rows r0 and r0 + 8 of every fragment; the
  // register pair 4j + 2r, 4j + 2r + 1 of a 64-column fragment is row
  // r0 + 8r, columns 8j + cq and 8j + cq + 1.
  const int r0 = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[kBlocks][kO];
#pragma unroll
  for (int c = 0; c < kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < kO; ++i) acc[c][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  if (n > 0) mbar_wait(bar_q, 0);

  for (int it = 0; it < n; ++it) {
    const int st = it % kStages, k0 = (kt_begin + it) * BK;
    const uint32_t ks = k_s + st * T::kKVBytes, vs = v_s + st * T::kKVBytes;
    mbar_wait(bar_q + 8 * (1 + st), (it / kStages) & 1);

    float s[BK / 2];
    wgmma_fence();
    issue_s<D>(s, q_s, ks);
    wgmma_commit();
    wgmma_wait();
    hold(s);

    // Only tiles on an edge of the band or the sequences need the
    // per-element mask.
    const bool edge = k0 + BK > seq_k || q0 + kBQ > seq_q ||
                      (causal && k0 + BK - 1 > first_row) ||
                      (has_window && k0 <= q0 + kBQ - 1 + off - window);
    PFrag<BK> p;
    float alpha[2];
    softmax_tile<BK>(s, p, m, l, alpha, edge, q0 + r0 + off, k0 + cq, mk,
                     scale_log2);
#pragma unroll
    for (int c = 0; c < kBlocks; ++c) {
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
      hold(acc[c]);
    }

    wgmma_fence();
    issue_pv<D>(acc, p, vs);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < kBlocks; ++c) hold(acc[c]);

    __syncthreads();                   // every thread is done with stage st
    if (tid == 0 && it + kStages < n)
      load_kv<D>(&tk, &tv, ks, vs, bar_q + 8 * (1 + st),
                 kt_begin + it + kStages, kvh, b);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= seq_q) continue;
    const bool any = l[r] > 0.f;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* out = o + b * os.b + h * os.h + qi * os.s;
#pragma unroll
    for (int c = 0; c < kBlocks; ++c)
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const float v0 = any ? acc[c][4 * j + 2 * r] / den : 0.f;
        const float v1 = any ? acc[c][4 * j + 2 * r + 1] / den : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(out + c * kCols + 8 * j + cq) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry), looked up once through the
// runtime, so the library links against the runtime only.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (d, seq, heads, batch) of a bf16 tensor with unit stride along
// d, boxes of (cols, rows, 1, 1).  A stride along a dimension of size 1 is
// never read, so it is replaced by one the encoder accepts.
int make_map(CUtensorMap* map, const void* ptr, int d, int seq, int heads,
             int batch, Strides st, int cols, int rows,
             CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t row = 2ull * d;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      seq > 1 ? 2ull * st.s : row, heads > 1 ? 2ull * st.h : row,
      batch > 1 ? 2ull * st.b : row};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int group, int seq_q, int seq_k, Strides qs, Strides ks,
              Strides vs, Strides os, float scale, int causal, int has_window,
              int window, cudaStream_t stream) {
  using T = TcTile<D>;
  const CUtensorMapSwizzle swizzle = T::kSwz == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, D, seq_q, H, B, qs, T::kCols, kBQ, swizzle);
  if (e == 0)
    e = make_map(&tk, k, D, seq_k, H / group, B, ks, T::kCols, T::kBK,
                 swizzle);
  if (e == 0)
    e = make_map(&tv, v, D, seq_k, H / group, B, vs, T::kCols, T::kBK,
                 swizzle);
  if (e != 0) return e;
  const cudaError_t ce = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const dim3 grid((seq_q + kBQ - 1) / kBQ, H, B);
  flash_fwd_tc<D><<<grid, kWG, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), os, group, seq_q, seq_k,
      scale * kLog2e, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, Strides, Strides, Strides,
                         Strides, float, int, int, int, cudaStream_t);

// dtype 0: the fp32 body; dtype 1: the bf16 tensor-core body.
template <int D>
LaunchFn pick_body(int dtype) {
  return dtype == 0 ? &launch<float, D> : &launch_tc<D>;
}

LaunchFn pick(int dtype, int d) {
  switch (d) {
    case 64: return pick_body<64>(dtype);
    case 96: return pick_body<96>(dtype);
    case 128: return pick_body<128>(dtype);
    case 256: return pick_body<256>(dtype);
    default: return nullptr;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and out alike).  d: 64, 96, 128 or
// 256.  Strides are in elements: (batch, head, sequence) for each tensor,
// unit along d; bf16 needs the alignment rule of the header note.  group =
// H / KV.  has_window = 0 ignores window.  Returns cudaGetLastError() after
// the launch (100000 + a CUresult if a tensor map is refused).
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int d,
    int B, int H, int group, int seq_q, int seq_k, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale, int causal,
    int has_window, int window, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const LaunchFn fn = dtype == 0 || dtype == 1 ? pick(dtype, d) : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, B, H, group, seq_q, seq_k, qs, ks, vs, os, scale,
            causal, has_window, window, static_cast<cudaStream_t>(stream));
}
