// JAX's activations for Hopper (sm_90a): forward, gated and backward.
//
// Replaces no Pallas kernel.  It is the counterpart of the loop XLA fuses
// each activation into: XLA expands jax.nn.sigmoid / silu / gelu (tanh
// form) / softplus / log_sigmoid and jnp.tanh into their primitives and,
// at bf16, rounds to bf16 after every one, then runs the chain as one
// loop.  The port's plain version (kernels/activations/ref.py) writes the
// same primitives as eager torch ops, one kernel each; this source runs
// the chain in registers, with the same roundings, so that it gives the
// bits those eager ops give on the card:
//
//   * each op computes in fp32 as torch's eager kernel does (the precise
//     expf / tanhf / log1pf, an IEEE reciprocal) and, for bf16, rounds its
//     result with __float2bfloat16_rn, as an eager bf16 op stores it;
//   * every product, sum and difference is written with __fmul_rn /
//     __fadd_rn / __fsub_rn, so nvcc contracts none into an fma: an
//     eager chain rounds after each op, in fp32 as in bf16;
//   * the constants come from the caller in the tensor's dtype (gelu's
//     0.0446777344 and 0.796875 in bf16), as the eager chain holds them;
//   * softplus's max(x, 0) keeps a NaN (torch.clamp_min does; fmaxf
//     would not), and its backward replaces +inf by 0 before the
//     difference, as JAX's logaddexp rule does.
//
// Four forms over one elementwise body, templated on the function and
// the dtype (fp32, bf16):
//   forward     y = f(x)
//   gated       y = up * f(gate)              (the MLP's h * act(gate))
//   backward    dx = f'(g; saved)             (JAX's rules, op for op)
//   gated bwd   d_up = g * f(gate), d_gate = f'(g * up; gate)
// The backward reads what the plain version's autograd Functions save:
// sigmoid and tanh their output, softplus and log_sigmoid input and
// output; silu and gelu their input alone, recomputing sigmoid(x) and
// tanh(inner) in registers (the same bits, one saved tensor fewer).
// silu's backward is what autograd composes through x * sigmoid(x):
// g * s + (g * x) * (s * (1 - s)).
//
// Layout.  Each input is read as (rows, cols) with unit stride along cols
// and its own row stride (a contiguous tensor is one row; the sLSTM's
// g[:, k] and the RG-LRU's chunks are strided rows); outputs are
// contiguous.  A thread takes 16 bytes of a row (8 bf16 or 4 fp32 values)
// in one load when every pointer, stride and cols allow it, else in
// separate loads (and a ragged end of a row in fewer).
//
// Bound.  Bytes: each input read once, each output written once; the
// arithmetic is a few dozen fp32 ops a value, far under the card's 67
// TFLOP/s at 3.35 TB/s (bf16 silu: 4 bytes and ~40 ops a value).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Fn { kSigmoid = 0, kSilu = 1, kGelu = 2, kSoftplus = 3,
          kLogSigmoid = 4, kTanh = 5 };
enum Form { kForward = 0, kGated = 1, kBackward = 2, kGatedBackward = 3 };

// An eager op's result as its output tensor holds it.
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> struct Op {
  static __device__ __forceinline__ float mul(float a, float b) {
    return rnd<T>(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return rnd<T>(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return rnd<T>(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ float recip(float a) {
    return rnd<T>(__frcp_rn(a));   // = the IEEE 1 / a
  }
  static __device__ __forceinline__ float exp(float a) {
    return rnd<T>(expf(a));
  }
  static __device__ __forceinline__ float tanh(float a) {
    return rnd<T>(tanhf(a));
  }
  static __device__ __forceinline__ float log1p(float a) {
    return rnd<T>(log1pf(a));
  }
  // torch.clamp_min(x, 0): NaN stays NaN
  static __device__ __forceinline__ float relu(float a) {
    return isnan(a) ? a : fmaxf(a, 0.0f);
  }
  // where(x == inf, 0, x)
  static __device__ __forceinline__ float finite_or_zero(float a) {
    return a == INFINITY ? 0.0f : a;
  }
};

struct Consts { float c1, c2; };      // gelu's, in the tensor's dtype

// (exp(-x) + 1).reciprocal()
template <typename T> __device__ __forceinline__ float logistic(float x) {
  using O = Op<T>;
  return O::recip(O::add(O::exp(-x), 1.0f));
}

// clamp_min(x, 0) + log1p(exp(-|x|))
template <typename T> __device__ __forceinline__ float softplus(float x) {
  using O = Op<T>;
  return O::add(O::relu(x), O::log1p(O::exp(-fabsf(x))));
}

// tanh((x + ((x * x) * x) * c1) * c2)
template <typename T>
__device__ __forceinline__ float gelu_inner(float x, Consts k) {
  using O = Op<T>;
  return O::tanh(O::mul(O::add(x, O::mul(O::mul(O::mul(x, x), x), k.c1)),
                        k.c2));
}

template <int F, typename T>
__device__ __forceinline__ float forward(float x, Consts k) {
  using O = Op<T>;
  if (F == kSigmoid) return logistic<T>(x);
  if (F == kSilu) return O::mul(x, logistic<T>(x));
  if (F == kGelu)                          // x * ((t + 1) * 0.5)
    return O::mul(x, O::mul(O::add(gelu_inner<T>(x, k), 1.0f), 0.5f));
  if (F == kSoftplus) return softplus<T>(x);
  if (F == kLogSigmoid) return -softplus<T>(-x);
  return O::tanh(x);
}

// The input's cotangent from the output's (g), the input x and the output
// y = forward(x); each function reads only what its plain version saves.
template <int F, typename T>
__device__ __forceinline__ float backward(float g, float x, float y,
                                          Consts k) {
  using O = Op<T>;
  if (F == kSigmoid)                       // g * (s * (1 - s))
    return O::mul(g, O::mul(y, O::sub(1.0f, y)));
  if (F == kSilu) {                        // g * s + (g * x) * (s * (1 - s))
    const float s = logistic<T>(x);
    return O::add(O::mul(g, s),
                  O::mul(O::mul(g, x), O::mul(s, O::sub(1.0f, s))));
  }
  if (F == kGelu) {
    const float t = gelu_inner<T>(x, k);
    const float half = O::mul(O::mul(x, g), 0.5f);
    const float d = O::mul(half, O::sub(1.0f, t));
    const float r = O::mul(O::add(d, O::mul(d, t)), k.c2);
    const float a = O::mul(g, O::mul(O::add(t, 1.0f), 0.5f));
    return O::add(O::add(a, r),
                  O::mul(O::mul(r, k.c1), O::mul(O::mul(x, x), 3.0f)));
  }
  if (F == kSoftplus)                      // g * exp(x - out), inf -> 0
    return O::mul(g, O::exp(O::sub(O::finite_or_zero(x),
                                   O::finite_or_zero(y))));
  if (F == kLogSigmoid) {                  // -softplus(-x): its rule on -g
    const float e = O::exp(O::sub(O::finite_or_zero(-x),
                                  O::finite_or_zero(-y)));
    return -O::mul(-g, e);
  }
  const float d = O::mul(g, O::sub(1.0f, y));   // tanh: d + d * t
  return O::add(d, O::mul(d, y));
}

template <int F> __host__ __device__ constexpr bool reads_x() {
  return F != kSigmoid && F != kTanh;
}
template <int F> __host__ __device__ constexpr bool reads_y() {
  return F == kSigmoid || F == kTanh || F == kSoftplus || F == kLogSigmoid;
}

template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T to(float v);
template <> __device__ __forceinline__ float to<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);           // exact: v is already rounded
}

// V values from p: one 16-byte load, or V loads of the first n (the rest
// of a ragged row reads as 0 and is never stored).
template <bool VEC, typename T, int V>
__device__ __forceinline__ void load(const T* p, int n, float (&out)[V]) {
  if (VEC) {
    const Vec<T, V> q = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = as_float(q.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = i < n ? as_float(p[i]) : 0.0f;
  }
}

template <bool VEC, typename T, int V>
__device__ __forceinline__ void store(T* p, int n, const float (&a)[V]) {
  if (VEC) {
    Vec<T, V> q;
#pragma unroll
    for (int i = 0; i < V; ++i) q.v[i] = to<T>(a[i]);
    *reinterpret_cast<Vec<T, V>*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < n) p[i] = to<T>(a[i]);
  }
}

struct Args {
  const void* a;      // forward: x; gated: up; backward: g; gated bwd: g
  const void* b;      // gated: gate; backward: x (or null); gated bwd: up
  const void* c;      // backward: y (or null); gated bwd: gate
  void* out0;         // y, dx or d_up
  void* out1;         // gated bwd: d_gate
  long long rows, cols;
  long long sa, sb, sc;   // row strides of a, b, c, in elements
  Consts k;
};

// A thread takes V consecutive values of a row (16 bytes): blockIdx.x and
// the thread pick them along cols, blockIdx.y (and its stride) the row.
template <int F, int FORM, typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) act_kernel(Args args) {
  constexpr int V = 16 / sizeof(T);
  const long long col = (blockIdx.x * (long long)kThreads + threadIdx.x) * V;
  if (col >= args.cols) return;
  const long long left = args.cols - col;
  const int n = left < V ? (int)left : V;
  const T* a = static_cast<const T*>(args.a);
  const T* b = static_cast<const T*>(args.b);
  const T* c = static_cast<const T*>(args.c);
  T* out0 = static_cast<T*>(args.out0);
  T* out1 = static_cast<T*>(args.out1);
  for (long long r = blockIdx.y; r < args.rows; r += gridDim.y) {
    float va[V], vb[V], vc[V], o0[V], o1[V];
    load<VEC>(a + r * args.sa + col, n, va);
    if (FORM != kForward && (FORM != kBackward || reads_x<F>()))
      load<VEC>(b + r * args.sb + col, n, vb);
    if (FORM == kGatedBackward || (FORM == kBackward && reads_y<F>()))
      load<VEC>(c + r * args.sc + col, n, vc);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (FORM == kForward) {
        o0[i] = forward<F, T>(va[i], args.k);
      } else if (FORM == kGated) {
        o0[i] = Op<T>::mul(va[i], forward<F, T>(vb[i], args.k));
      } else if (FORM == kBackward) {
        o0[i] = backward<F, T>(va[i], reads_x<F>() ? vb[i] : 0.0f,
                               reads_y<F>() ? vc[i] : 0.0f, args.k);
      } else {                             // g = va, up = vb, gate = vc
        const float act = forward<F, T>(vc[i], args.k);
        o0[i] = Op<T>::mul(va[i], act);
        o1[i] = backward<F, T>(Op<T>::mul(va[i], vb[i]), vc[i], act,
                               args.k);
      }
    }
    store<VEC>(out0 + r * args.cols + col, n, o0);
    if (FORM == kGatedBackward) store<VEC>(out1 + r * args.cols + col, n, o1);
  }
}

template <int F, int FORM, typename T>
int launch_one(const Args& args, int vec, cudaStream_t s) {
  constexpr long long V = 16 / sizeof(T);
  const long long bx = (args.cols + V * kThreads - 1) / (V * kThreads);
  if (bx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)bx, (unsigned)(args.rows < 65535 ? args.rows
                                                             : 65535));
  if (vec) act_kernel<F, FORM, T, true><<<grid, kThreads, 0, s>>>(args);
  else act_kernel<F, FORM, T, false><<<grid, kThreads, 0, s>>>(args);
  return 0;
}

template <int F, int FORM>
int by_dtype(const Args& args, int dtype, int vec, cudaStream_t s) {
  if (dtype == 0) return launch_one<F, FORM, float>(args, vec, s);
  if (dtype == 1) return launch_one<F, FORM, __nv_bfloat16>(args, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int F>
int by_form(const Args& args, int form, int dtype, int vec, cudaStream_t s) {
  switch (form) {
    case kForward: return by_dtype<F, kForward>(args, dtype, vec, s);
    case kGated: return by_dtype<F, kGated>(args, dtype, vec, s);
    case kBackward: return by_dtype<F, kBackward>(args, dtype, vec, s);
    case kGatedBackward:
      return by_dtype<F, kGatedBackward>(args, dtype, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// fn: Fn; form: Form; dtype: 0 fp32, 1 bf16; vec: 1 if every pointer is
// 16-byte aligned and cols and the row strides are multiples of 16 bytes.
// Returns cudaGetLastError() after the launch.
extern "C" int act_launch(int fn, int form, int dtype, const void* a,
                          const void* b, const void* c, void* out0,
                          void* out1, long long rows, long long cols,
                          long long sa, long long sb, long long sc, float c1,
                          float c2, int vec, void* stream) {
  const Args args{a, b, c, out0, out1, rows, cols, sa, sb, sc, {c1, c2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return 0;
  int status;
  switch (fn) {
    case kSigmoid: status = by_form<kSigmoid>(args, form, dtype, vec, s); break;
    case kSilu: status = by_form<kSilu>(args, form, dtype, vec, s); break;
    case kGelu: status = by_form<kGelu>(args, form, dtype, vec, s); break;
    case kSoftplus: status = by_form<kSoftplus>(args, form, dtype, vec, s); break;
    case kLogSigmoid:
      status = by_form<kLogSigmoid>(args, form, dtype, vec, s); break;
    case kTanh: status = by_form<kTanh>(args, form, dtype, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (status) return status;
  return static_cast<int>(cudaGetLastError());
}
