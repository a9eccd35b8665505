// Krum scores and Bulyan's selection from squared distances, for Hopper
// (sm_90a).
//
// krum_scores_kernel replaces src/repro/kernels/coord_stats/kernel.py::
// krum_scores_pallas (body _make_krum_kernel): from the (W, W) fp32 squared
// distances D2, each worker's score is the sum of its k = max(W - f - 2, 1)
// smallest distances to the other workers, summed in ascending order.
// Self is left out (a worker with fewer than k others adds +inf, as the
// reference's +inf diagonal does).
//
// bulyan_select_kernel replaces bulyan_select_pallas (body
// _make_bulyan_kernel): all theta = max(W - 2f, 1) rounds of Bulyan's
// recursive Multi-Krum selection in one launch.  Availability lives in
// shared memory; a picked worker stays in every later row's sum as the
// finite big = 4 * max(off-diagonal D2) + 1 (the same count per row, so the
// real distances decide), and scores nothing itself (+inf); the argmin
// takes the lowest index on ties, as jnp.argmin does.  The kernel writes
// picks[r], the worker taken in round r, which is the selection order that
// the TPU kernel's wrapper recovers with a stable argsort.
//
// Design.  One block, one thread per worker.  A thread finds its k
// smallest distances by k passes of a minimum over its row in (value,
// index) order, so ties are taken in index order and the sum runs in
// ascending order of value, the order of the plain version's sorted rows:
// the two give the same scores, and so the same picks.
//
// Bound.  The work is ~1 KB of data and a few thousand operations at
// W = 15: both bounds are nanoseconds, so the launch latency bounds these
// kernels.  They exist to keep the selection on the card, with no host
// round trip between the Gram and the combine.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWorkers = 1024;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Sum of the k smallest d[j] (j != self, j < w), ascending; value(j) gives
// d[j].  Fewer than k candidates add +inf.
template <typename V>
__device__ float k_smallest_sum(int self, int w, int k, V value) {
  const float inf = inf_f();
  float acc = 0.f, pv = -inf;
  int pj = -1;
  for (int r = 0; r < k; ++r) {
    float bv = inf;
    int bj = w;
    for (int j = 0; j < w; ++j) {
      if (j == self) continue;
      const float v = value(j);
      const bool after = v > pv || (v == pv && j > pj);
      const bool better = v < bv || (v == bv && j < bj);
      if (after && better) {
        bv = v;
        bj = j;
      }
    }
    acc += bv;  // +inf when no candidate is left
    pv = bv;
    pj = bj;
  }
  return acc;
}

__global__ void krum_scores_kernel(const float* __restrict__ d2, int w, int k,
                                   float* __restrict__ out) {
  const int i = threadIdx.x;
  if (i >= w) return;
  const float* row = d2 + static_cast<long long>(i) * w;
  out[i] = k_smallest_sum(i, w, k, [&](int j) { return row[j]; });
}

__global__ void bulyan_select_kernel(const float* __restrict__ d2, int w,
                                     int k, int theta,
                                     int* __restrict__ picks) {
  __shared__ int s_avail[kMaxWorkers];
  __shared__ float s_score[kMaxWorkers];
  __shared__ float s_big;
  const int i = threadIdx.x;
  const float inf = inf_f();
  const float* row = d2 + static_cast<long long>(i) * w;
  if (i < w) {
    float m = 0.f;
    for (int j = 0; j < w; ++j)
      if (j != i) m = fmaxf(m, row[j]);
    s_score[i] = m;
    s_avail[i] = 1;
  }
  __syncthreads();
  if (i == 0) {
    float m = 0.f;
    for (int j = 0; j < w; ++j) m = fmaxf(m, s_score[j]);
    s_big = 4.0f * m + 1.0f;
  }
  __syncthreads();
  const float big = s_big;
  for (int r = 0; r < theta; ++r) {
    if (i < w) {
      s_score[i] = s_avail[i]
          ? k_smallest_sum(i, w, k, [&](int j) {
              return s_avail[j] ? row[j] : big;
            })
          : inf;
    }
    __syncthreads();
    if (i == 0) {
      float best = s_score[0];
      int bi = 0;
      for (int j = 1; j < w; ++j) {
        if (s_score[j] < best) {
          best = s_score[j];
          bi = j;
        }
      }
      picks[r] = bi;
      s_avail[bi] = 0;
    }
    __syncthreads();
  }
}

unsigned int threads_for(int w) { return static_cast<unsigned int>((w + 31) / 32 * 32); }

}  // namespace

// d2: (w, w) fp32, row-major contiguous.  out: w fp32.
extern "C" int krum_scores_launch(const float* d2, int w, int f, float* out,
                                  void* stream) {
  if (w < 1 || w > kMaxWorkers || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int k = w - f - 2 > 1 ? w - f - 2 : 1;
  krum_scores_kernel<<<1, threads_for(w), 0, static_cast<cudaStream_t>(stream)>>>(
      d2, w, k, out);
  return static_cast<int>(cudaGetLastError());
}

// d2: (w, w) fp32, row-major contiguous.  picks: theta int32.
extern "C" int bulyan_select_launch(const float* d2, int w, int f, int* picks,
                                    void* stream) {
  if (w < 1 || w > kMaxWorkers || f < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int k = w - f - 2 > 1 ? w - f - 2 : 1;
  const int theta = w - 2 * f > 1 ? w - 2 * f : 1;
  bulyan_select_kernel<<<1, threads_for(w), 0, static_cast<cudaStream_t>(stream)>>>(
      d2, w, k, theta, picks);
  return static_cast<int>(cudaGetLastError());
}
