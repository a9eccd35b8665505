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
// heaviest causal query tiles first (the fp32 body over the whole grid,
// the bf16 body within each (b, h)); one block owns one (b, h, query
// tile) and loops over the key tiles itself.
//
// Bound.  4 * D FLOP per (query, key) pair kept by the mask (2 * D for
// q.k, 2 * D for p.v): at the serving path's prefill (S = 2048, D = 64)
// ~128 FLOP per byte of q, k, v and out, far above the card's ridge, so
// the function is bound by operations: at the bf16 tensor-core rate
// (989 TFLOP/s) for bf16, at the fp32 CUDA-core rate (67 TFLOP/s) for
// fp32.
//
// Both bodies load q, k and v with TMA: the host encodes three 4-D tensor
// maps (d, seq, head, batch) per call from the pointers and byte strides;
// GQA is the head coordinate h / group.  Q's tile is loaded once; K and V
// tiles go through a ring, one mbarrier a slot, so the next tile's copy is
// in flight while this tile computes; TMA zero-fills what lies past Sq,
// Sk or D, and the masks still decide by index.
// Alignment rule (TMA): q, k and v start on a 16-byte boundary and every
// stride but d's (unit) is a multiple of 16 bytes, i.e. of 8 bf16 or 4
// fp32 elements; the stride of a dimension of size 1 is never read.  The
// wrapper checks it and raises; it never copies.
//
// Two bodies, chosen by dtype (no switch, no fallback between them):
//
// fp32 (dtype 0): flash_fwd<D>, fp32 FMAs on the CUDA cores (67 TFLOP/s:
//   128 FMA lanes an SM).  It keeps fp32 accuracy, which TF32 tensor cores
//   would not, and serves the fp32 reduced configurations and the fp32
//   prefix check.  Shared memory feeds the FMAs: an SM delivers ~32
//   floats a clock from it against 128 FMAs, so each float a thread loads
//   must feed at least 4 FMAs, and that takes register tiles (F32Tile<D>).
//   - Register tiles: a warp owns kRW query rows outright; lane (ty, tx),
//     ty = lane / 8, tx = lane % 8, holds the scores of its kTM consecutive
//     rows (kTM ty ..) against the keys tx + 8 j (j < kTN), and the output
//     of the same rows at the columns 4 (tx + 8 c) .. + 3.  At D = 64 both
//     tiles are 8 x 8: 4 FMAs a float loaded.  At D = 96 and 128 the score
//     tile is 8 x 4 (32-key tiles: at D = 96 two blocks of 4 warps then fit
//     an SM, which beat one block of 64-key tiles), at 256 4 x 4 (the
//     accumulator, kTM x D / 8, leaves no more room without a spill), so
//     Q K^T loads more a FMA there.
//   - Operands: one side of every FMA is a float4 of consecutive registers
//     (the thread's rows) and the other a value reused over them.  Q is
//     staged through the K/V ring once per block and turned into Q^T
//     (d-major), scaled by scale * log2 e; per column d a thread loads its
//     rows of Q^T, and per 4 columns each of its keys' float4 of K.  The
//     softmax writes P transposed, so P V loads a float4 of rows a key and
//     V's float4 of the thread's columns.
//   - Shared layout without bank conflicts: K and V land in boxes of at
//     most 128 columns whose rows TMA pads by 4 floats (the box is 4
//     columns wider than its span: past D it is zero-filled, inside D the
//     extra columns are never read), so the 8 keys a warp reads at one
//     column fall in 8 distinct 16-byte bank groups; lanes that share a
//     row or key read one address (a broadcast).
//   - The rows of a warp are its own, so P goes through a warp-private
//     P^T behind __syncwarp, and a warp whose rows see no key of a tile
//     skips it.
//   - Softmax on the score registers: the 8 lanes of a row reduce its max
//     and sum with shuffles, the rows side by side; p = 2^(x - m) in one
//     MUFU ex2.approx; the accumulator is rescaled only where a row's max
//     moved (else alpha is 1).  Tiles off every edge skip the mask code.
//   - Ring: three slots that K(t) and V(t) take in turn.  Each warp
//     counts itself out of a slot when done with it; the last one out
//     refills it with the use three ahead, so no block barrier stands in
//     the loop and warps drift apart by up to a tile.
//   - Grid: one dimension with the query tile slowest, so every causal
//     block that sees the most keys starts before any lighter one; with
//     each head's tiles ordered only among themselves (the bf16 body's
//     grid), the last heads' heaviest tiles started last and set a tail.
//
// bf16 (dtype 1): flash_fwd_tc<D>, the tensor cores.  One warpgroup (128
//   threads) per block owns 64 query rows; warp w holds rows 16w .. 16w+15
//   of every fragment.
//   - Loads: TMA, as above, a 2-stage ring of K and V tiles of 64 keys
//     (32 at D = 256);
//     tiles land 128-byte swizzled in column blocks of 64 (64-byte swizzle
//     in blocks of 32 at D = 96, whose 192-byte rows do not split into
//     128-byte ones).
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
constexpr int kBQ = 64;                // query rows of a bf16 block

struct Strides {
  long long b, h, s;                   // in elements; unit stride along D
};

// ------------------------------------------------------ TMA and barriers

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = 100000;

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

// 2^x, x <= 0, in one MUFU instruction (<= 2 ulp; results below 2^-126
// flush to 0, an absolute error under 1.2e-38).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// A 4-D map (d, seq, heads, batch) of a tensor of ``type`` (``esize``
// bytes an element) with unit stride along d, boxes of (cols, rows, 1, 1).
// A stride along a dimension of size 1 is never read, so it is replaced by
// one the encoder accepts.
int make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
             int esize, int d, int seq, int heads, int batch, Strides st,
             int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t es = static_cast<cuuint64_t>(esize);
  const cuuint64_t row = es * d;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      seq > 1 ? es * st.s : row, heads > 1 ? es * st.h : row,
      batch > 1 ? es * st.b : row};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// ---------------------------------------------------------------- fp32 body

// The fp32 body's ring: K(t) and V(t) take its slots in turn (use 2 t and
// 2 t + 1), and the last warp out of a slot refills it with the use kSlots
// ahead, so three tiles' room keeps the next tile's copy in flight.
constexpr int kSlots = 3;

template <int D>
struct F32Tile {
  static constexpr int kTX = 8;                     // lanes along keys / d
  static constexpr int kTY = 32 / kTX;              // lanes along rows
  static constexpr int kTM = D <= 128 ? 8 : 4;      // rows of a thread
  static constexpr int kBK = D <= 64 ? 64 : 32;     // keys of a tile
  static constexpr int kWarps = D == 64 ? 8 : 4;
  static constexpr int kRW = kTM * kTY;             // rows of a warp
  static constexpr int kBQ = kRW * kWarps;          // rows of a block
  static constexpr int kTN = kBK / kTX;             // keys of a thread
  static constexpr int kTD = D / kTX;               // output columns of a thread
  static constexpr int kW = D < 128 ? D : 128;      // columns of a box
  static constexpr int kBoxes = D / kW;
  static constexpr int kCPB = kW / 4;               // float4 columns of a box
  static constexpr int kLD = kW + 4;                // floats of a box row
  static constexpr int kLQ = kBQ + 4;               // floats of a row of Q^T
  static constexpr int kLP = kRW + 4;               // floats of a row of P^T
  static constexpr int kQFloats = D * kLQ;
  static constexpr int kKVFloats = kBK * kBoxes * kLD;   // one K or V tile
  static constexpr int kPFloats = kWarps * kBK * kLP;
  static constexpr int kBarOff = 4 * (kQFloats + kSlots * kKVFloats + kPFloats);
  static constexpr int kSmem = kBarOff + 8 * (1 + kSlots) + 4 * kSlots + 128;
  static_assert(kCPB % kTX == 0 && kTD % 4 == 0 && kTM % 4 == 0,
                "float4 columns and rows");
  static_assert(kBQ * kBoxes * kLD <= kSlots * kKVFloats + kPFloats,
                "Q's rows are staged in the ring and P^T's room");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Component e (0..3, known at compile time) of v.
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// s = Q K^T for the thread's rows and keys.  ``q`` is the thread's first
// row in Q^T's first column (d = 0), ``k`` its first key of K's first box.
// Per column d, the FMAs of a key run over the thread's rows, which are
// consecutive registers, while the key's value is reused.
template <int D>
__device__ __forceinline__ void f32_scores(
    float (&s)[F32Tile<D>::kTM][F32Tile<D>::kTN], const float* q,
    const float* k) {
  using T = F32Tile<D>;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) s[i][j] = 0.f;
#pragma unroll
  for (int bx = 0; bx < T::kBoxes; ++bx) {
    const float* kb = k + bx * T::kBK * T::kLD;
#pragma unroll 2
    for (int c = 0; c < T::kCPB; ++c) {
      float4 kf[T::kTN];
#pragma unroll
      for (int j = 0; j < T::kTN; ++j)
        kf[j] = ld4(kb + j * T::kTX * T::kLD + 4 * c);
      const float* qd = q + (bx * T::kW + 4 * c) * T::kLQ;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 qa[T::kTM / 4];
#pragma unroll
        for (int i = 0; i < T::kTM / 4; ++i)
          qa[i] = ld4(qd + e * T::kLQ + 4 * i);
#pragma unroll
        for (int j = 0; j < T::kTN; ++j)
#pragma unroll
          for (int i = 0; i < T::kTM; ++i)
            s[i][j] = fmaf(comp(qa[i / 4], i % 4), comp(kf[j], e), s[i][j]);
      }
    }
  }
}

// Scores (already times scale * log2 e) -> P, written to the warp's P^T
// (``p``: the thread's first key and row); updates the running max m and
// sum l of the thread's rows and rescales acc where a row's max moved.  ``row`` is the absolute position of the first row,
// ``col`` the thread's first key.  kEdge: some element of the tile may be
// masked; a masked score becomes -inf, so its 2^(x - m) is 0 while m,
// which starts at the finite NEG, stays finite.  The rows' reductions over
// the 8 lanes of a row run side by side.
template <int D, bool kEdge>
__device__ __forceinline__ void f32_softmax(
    float (&s)[F32Tile<D>::kTM][F32Tile<D>::kTN],
    float (&acc)[F32Tile<D>::kTM][F32Tile<D>::kTD],
    float (&m)[F32Tile<D>::kTM], float (&l)[F32Tile<D>::kTM], float* p,
    int row, int col, int seq_k, int causal, int has_window, int window) {
  using T = F32Tile<D>;
  float mx[T::kTM], rs[T::kTM];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int r = row + i;
    mx[i] = kNeg;
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) {
      float x = s[i][j];
      if (kEdge) {
        const int c = col + T::kTX * j;
        bool ok = c < seq_k && r < seq_k;      // k-padding, q-padding
        if (causal) ok = ok && c <= r;
        if (has_window) ok = ok && c > r - window;
        x = ok ? x : -INFINITY;
      }
      s[i][j] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
#pragma unroll
  for (int sh = 1; sh < T::kTX; sh <<= 1)
#pragma unroll
    for (int i = 0; i < T::kTM; ++i)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], sh));
  float alpha[T::kTM];
  bool moved = false;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const float m_cur = fmaxf(m[i], mx[i]);
    alpha[i] = fast_exp2(m[i] - m_cur);            // <= 1, finite
    moved |= m_cur != m[i];
    m[i] = m_cur;
    l[i] *= alpha[i];
  }
  if (moved)                           // else every alpha is 1
#pragma unroll
    for (int i = 0; i < T::kTM; ++i)
#pragma unroll
      for (int c = 0; c < T::kTD; ++c) acc[i][c] *= alpha[i];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const float m_cur = m[i];
    rs[i] = 0.f;
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) {
      const float e = fast_exp2(s[i][j] - m_cur);
      p[j * T::kTX * T::kLP + i] = e;
      rs[i] += e;
    }
  }
#pragma unroll
  for (int sh = 1; sh < T::kTX; sh <<= 1)
#pragma unroll
    for (int i = 0; i < T::kTM; ++i)
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], sh);
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) l[i] += rs[i];
}

// acc += P V.  ``p`` is the thread's first row in the warp's P^T (key 0),
// ``v`` the tile's first key at the thread's first float4 column.  Per key
// the FMAs of a column run over the thread's rows (consecutive registers)
// while V's value is reused.
template <int D>
__device__ __forceinline__ void f32_pv(
    float (&acc)[F32Tile<D>::kTM][F32Tile<D>::kTD], const float* p,
    const float* v) {
  using T = F32Tile<D>;
#pragma unroll 4
  for (int key = 0; key < T::kBK; ++key) {
    float4 pa[T::kTM / 4];
#pragma unroll
    for (int i = 0; i < T::kTM / 4; ++i)
      pa[i] = ld4(p + key * T::kLP + 4 * i);
    const float* vk = v + key * T::kLD;
#pragma unroll
    for (int c = 0; c < T::kTD / 4; ++c) {
      // float4 column tx + 8 c: box 8 c / kCPB, (8 c) % kCPB + tx in it
      const float4 vf = ld4(vk + (T::kTX * c / T::kCPB) * T::kBK * T::kLD +
                            4 * (T::kTX * c % T::kCPB));
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < T::kTM; ++i)
          acc[i][4 * c + e] =
              fmaf(comp(pa[i / 4], i % 4), comp(vf, e), acc[i][4 * c + e]);
    }
  }
}

// Key tile ``kt`` of K or V (``map``) into a ring slot (one thread).
template <int D>
__device__ __forceinline__ void f32_load(const CUtensorMap* map,
                                         uint32_t slot, uint32_t bar, int kt,
                                         int kvh, int b) {
  using T = F32Tile<D>;
  mbar_expect_tx(bar, 4 * T::kKVFloats);
#pragma unroll
  for (int bx = 0; bx < T::kBoxes; ++bx)
    tma_load(slot + bx * 4 * T::kBK * T::kLD, map, bar, bx * T::kW,
             kt * T::kBK, kvh, b);
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kWarps * 32, 1)
flash_fwd(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
          Strides os, int heads, int group, int seq_q, int seq_k,
          float scale_log2, int causal, int has_window, int window) {
  using T = F32Tile<D>;
  constexpr int BK = T::kBK, BQ = T::kBQ, RW = T::kRW, LD = T::kLD;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // TMA boxes start on 128-byte boundaries.
  const uint32_t raw = smem_u32(smem_raw);
  float* const q_s = reinterpret_cast<float*>(
      smem_raw + (((raw + 127u) & ~127u) - raw));
  float* const ring = q_s + T::kQFloats;       // Q^T, then the ring's slots
  float* const p_s = ring + kSlots * T::kKVFloats;  // then P^T, one a warp
  const uint32_t bar_q = smem_u32(q_s) + T::kBarOff;  // then the barriers
  int* const out_of = reinterpret_cast<int*>(          // then the counts
      reinterpret_cast<uint8_t*>(q_s) + T::kBarOff + 8 * (1 + kSlots));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = lane / T::kTX, tx = lane % T::kTX;
  // One dimension, the query tile slowest: blocks start in index order, so
  // every (b, h)'s heaviest causal tile starts before any lighter one.
  const int nq = (seq_q + BQ - 1) / BQ;
  const int nhb = gridDim.x / nq;              // heads x batch
  const int qt = nq - 1 - blockIdx.x / nhb;
  const int h = blockIdx.x % nhb % heads, b = blockIdx.x % nhb / heads;
  const int kvh = h / group;
  const int q0 = qt * BQ;
  const int off = seq_k - seq_q;               // absolute row = i + off

  // Key tiles that can hold an unmasked key for some row of this tile.
  const int first_row = q0 + off;
  const int last_row = min(q0 + BQ, seq_q) - 1 + off;
  int kt_end = (seq_k + BK - 1) / BK;
  if (causal) kt_end = last_row < 0 ? 0 : min(kt_end, last_row / BK + 1);
  int kt_begin = 0;
  if (has_window) {
    const int lo = first_row - window + 1;     // lowest key any row keeps
    if (lo > 0) kt_begin = lo / BK;
  }
  const int n = max(kt_end - kt_begin, 0);

  // Q's rows land in the ring (and P^T's room) first; the block turns them
  // into Q^T (d-major), scaled by scale * log2 e, then the ring takes its
  // first tiles.  Use u of the ring is K (u even) or V (u odd) of key tile
  // kt_begin + u / 2, in slot u % kSlots, phase u / kSlots.
  auto load = [&](int u) {
    const int sl = u % kSlots;
    f32_load<D>(u & 1 ? &tv : &tk, smem_u32(ring + sl * T::kKVFloats),
                bar_q + 8 * (1 + sl), kt_begin + u / 2, kvh, b);
  };
  if (tid == 0 && n > 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(bar_q + 8 * (1 + s), 1);
      out_of[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 4 * BQ * T::kBoxes * LD);
#pragma unroll
    for (int bx = 0; bx < T::kBoxes; ++bx)
      tma_load(smem_u32(ring + bx * BQ * LD), &tq, bar_q, bx * T::kW, q0, h,
               b);
  }
  __syncthreads();
  if (n > 0) {
    mbar_wait(bar_q, 0);
    for (int idx = tid; idx < BQ * D / 4; idx += T::kWarps * 32) {
      const int r = idx % BQ, c4 = idx / BQ;
      const float4 x = ld4(ring + (c4 / T::kCPB) * BQ * LD + r * LD +
                           4 * (c4 % T::kCPB));
      q_s[(4 * c4) * T::kLQ + r] = x.x * scale_log2;
      q_s[(4 * c4 + 1) * T::kLQ + r] = x.y * scale_log2;
      q_s[(4 * c4 + 2) * T::kLQ + r] = x.z * scale_log2;
      q_s[(4 * c4 + 3) * T::kLQ + r] = x.w * scale_log2;
    }
    __syncthreads();
    if (tid == 0)
      for (int u = 0; u < kSlots && u < 2 * n; ++u) load(u);
  }

  // The warp's rows, first and last as absolute positions; the thread's
  // are kTM consecutive ones.
  const int wq = q0 + warp * RW;
  const int w_first = wq + off, w_last = wq + RW - 1 + off;
  const float* q_t = q_s + warp * RW + T::kTM * ty;
  float* p_t = p_s + warp * BK * T::kLP + T::kTM * ty;
  float acc[T::kTM][T::kTD], m[T::kTM], l[T::kTM];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < T::kTD; ++c) acc[i][c] = 0.f;
  }

  // Waits for use u's tile.  Every warp waits for each use, even one it
  // skips, so no warp counts itself into a slot's next round before the
  // refill has reset the count.
  auto wait = [&](int u) {
    mbar_wait(bar_q + 8 * (1 + u % kSlots), (u / kSlots) & 1);
  };
  // The warp is done with use u: the last warp out of its slot refills it.
  auto done = [&](int u) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const int sl = u % kSlots;
      if (atomicAdd(out_of + sl, 1) == T::kWarps - 1) {
        out_of[sl] = 0;
        __threadfence_block();
        if (u + kSlots < 2 * n) load(u + kSlots);
      }
    }
  };
  for (int it = 0; it < n; ++it) {
    const int k0 = (kt_begin + it) * BK, uk = 2 * it, uv = uk + 1;
    // A warp whose rows all lie past Sq, or see no key of this tile,
    // leaves m, l and acc as they are.
    const bool live = wq < seq_q && !(causal && k0 > w_last) &&
                      !(has_window && k0 + BK - 1 <= w_first - window);
    float s[T::kTM][T::kTN];
    wait(uk);
    if (live) f32_scores<D>(s, q_t, ring + (uk % kSlots) * T::kKVFloats +
                                        tx * LD);
    done(uk);
    wait(uv);
    if (live) {
      // Only tiles on an edge of the band or the sequences need the
      // per-element mask.
      const bool edge = k0 + BK > seq_k || wq + RW > seq_q ||
                        (causal && k0 + BK - 1 > w_first) ||
                        (has_window && k0 <= w_last - window);
      float* pw = p_t + tx * T::kLP;
      const int row = w_first + T::kTM * ty;
      if (edge)
        f32_softmax<D, true>(s, acc, m, l, pw, row, k0 + tx, seq_k, causal,
                             has_window, window);
      else
        f32_softmax<D, false>(s, acc, m, l, pw, row, k0 + tx, seq_k, causal,
                              has_window, window);
      __syncwarp();
      f32_pv<D>(acc, p_t, ring + (uv % kSlots) * T::kKVFloats + 4 * tx);
    }
    done(uv);
  }

#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int qi = wq + T::kTM * ty + i;
    if (qi >= seq_q) continue;
    const bool any = l[i] > 0.f;
    const float den = fmaxf(l[i], 1e-30f);
    float* out = o + b * os.b + h * os.h + qi * os.s + 4 * tx;
#pragma unroll
    for (int c = 0; c < T::kTD / 4; ++c) {
      float4 r;
      r.x = any ? acc[i][4 * c] / den : 0.f;
      r.y = any ? acc[i][4 * c + 1] / den : 0.f;
      r.z = any ? acc[i][4 * c + 2] / den : 0.f;
      r.w = any ? acc[i][4 * c + 3] / den : 0.f;
      *reinterpret_cast<float4*>(out + 4 * T::kTX * c) = r;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int group, int seq_q, int seq_k, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int has_window,
           int window, cudaStream_t stream) {
  using T = F32Tile<D>;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, f32, 4, D, seq_q, H, B, qs, T::kLD, T::kBQ,
                   none);
  if (e == 0)
    e = make_map(&tk, k, f32, 4, D, seq_k, H / group, B, ks, T::kLD, T::kBK,
                 none);
  if (e == 0)
    e = make_map(&tv, v, f32, 4, D, seq_k, H / group, B, vs, T::kLD, T::kBK,
                 none);
  if (e != 0) return e;
  const cudaError_t ce = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  const long long blocks =               // query tiles x H x B
      static_cast<long long>((seq_q + T::kBQ - 1) / T::kBQ) * H * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  flash_fwd<D><<<grid, T::kWarps * 32, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), os, H, group, seq_q, seq_k,
      scale * kLog2e, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 body

using bf16 = __nv_bfloat16;
constexpr int kWG = 128;               // one warpgroup owns a block's rows
constexpr int kStages = 2;             // depth of the K/V ring

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

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int group, int seq_q, int seq_k, Strides qs, Strides ks,
              Strides vs, Strides os, float scale, int causal, int has_window,
              int window, cudaStream_t stream) {
  using T = TcTile<D>;
  const CUtensorMapSwizzle swizzle = T::kSwz == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, bf, 2, D, seq_q, H, B, qs, T::kCols, kBQ,
                   swizzle);
  if (e == 0)
    e = make_map(&tk, k, bf, 2, D, seq_k, H / group, B, ks, T::kCols,
                 T::kBK, swizzle);
  if (e == 0)
    e = make_map(&tv, v, bf, 2, D, seq_k, H / group, B, vs, T::kCols,
                 T::kBK, swizzle);
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
  return dtype == 0 ? &launch<D> : &launch_tc<D>;
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
// unit along d; both need the alignment rule of the header note.  group =
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
