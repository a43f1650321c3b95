// Fused softmax cross-entropy for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels flexflow_tpu/ops/pallas_kernels.py::
// _xent_fwd_kernel and ::_xent_bwd_kernel (launched by _xent_calls, reached
// through softmax_xent).  Over (N, V) logits and int32 labels in [0, V):
//
//   forward:  lse = log sum_j exp(x_j),  nll = lse - x[label],
//             pred = argmax_j x_j (the first index among equal maxima, as
//             jnp.argmax breaks ties)                       -> f32, f32, i32
//   backward: dlogits = exp(x - lse) * (g_nll + g_lse) - onehot(label) * g_nll
//             written in the logits' type.
//
// The softmax is never written to memory.  Logits are read in their own
// type and widened in registers (exactly what the reference's f32 cast
// gives), and dlogits are rounded once to the logits' type.  A label
// outside [0, V) yields a NaN nll instead of a read out of bounds.
//
// Design.  One 256-thread CTA per row.  Forward: each thread streams its
// strided 8-element chunks (16-byte loads when V % 8 == 0, scalar loads
// otherwise) keeping an online max / sum-exp pair and a running argmax that
// moves only on a strict '>' (its chunks come in increasing index order, so
// it holds its first maximum); the CTA then merges the pairs with warp
// shuffles and shared memory, preferring the smaller index on equal values.
// Backward: the same walk, one exp per element, written back in place of
// the read.
//
// Bound.  Bytes: the forward reads the logits once (N*V*itemsize), the
// backward reads them and writes dlogits once; both are far below the
// card's operation rate.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Stat {
  float m;    // running max
  float l;    // sum of exp(x - m)
  float bv;   // argmax value
  int bi;     // argmax index (first among equal values)
};

__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  Stat r;
  r.m = fmaxf(a.m, b.m);
  r.l = a.l * expf(a.m - r.m) + b.l * expf(b.m - r.m);
  const bool take_b = b.bv > a.bv || (b.bv == a.bv && b.bi < a.bi);
  r.bv = take_b ? b.bv : a.bv;
  r.bi = take_b ? b.bi : a.bi;
  return r;
}

__device__ __forceinline__ void absorb(Stat& st, const float* x, int n, int base) {
  float cm = x[0];
  int ci = 0;
  for (int e = 1; e < n; ++e) {
    if (x[e] > cm) {
      cm = x[e];
      ci = e;
    }
  }
  if (cm > st.m) {
    st.l *= expf(st.m - cm);
    st.m = cm;
  }
  for (int e = 0; e < n; ++e) st.l += expf(x[e] - st.m);
  if (cm > st.bv) {
    st.bv = cm;
    st.bi = base + ci;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                float* __restrict__ nll, float* __restrict__ lse,
                int* __restrict__ pred, int v) {
  __shared__ Stat warp_stats[kWarps];
  const size_t row = blockIdx.x;
  const T* x = logits + row * (size_t)v;
  Stat st{ff::kNegInf, 0.f, -INFINITY, 0};
  if (VEC) {
    for (int c = threadIdx.x * 8; c < v; c += kThreads * 8) {
      float vals[8];
      ff::load8(x + c, vals);
      absorb(st, vals, 8, c);
    }
  } else {
    for (int c = threadIdx.x; c < v; c += kThreads) {
      const float val = ff::to_float(x[c]);
      absorb(st, &val, 1, c);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stat o;
    o.m = __shfl_xor_sync(0xffffffffu, st.m, off);
    o.l = __shfl_xor_sync(0xffffffffu, st.l, off);
    o.bv = __shfl_xor_sync(0xffffffffu, st.bv, off);
    o.bi = __shfl_xor_sync(0xffffffffu, st.bi, off);
    st = merge(st, o);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_stats[warp] = st;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stat r = warp_stats[0];
    for (int w = 1; w < kWarps; ++w) r = merge(r, warp_stats[w]);
    const float ls = r.m + logf(r.l);
    const int lab = labels[row];
    const float target = (lab >= 0 && lab < v) ? ff::to_float(x[lab]) : NAN;
    lse[row] = ls;
    nll[row] = ls - target;
    pred[row] = r.bi;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g_nll,
                const float* __restrict__ g_lse, T* __restrict__ dlogits,
                int v) {
  const size_t row = blockIdx.x;
  const T* x = logits + row * (size_t)v;
  T* dx = dlogits + row * (size_t)v;
  const float ls = lse[row];
  const float gn = g_nll != nullptr ? g_nll[row] : 0.f;
  const float g = gn + (g_lse != nullptr ? g_lse[row] : 0.f);
  const int lab = labels[row];
  if (VEC) {
    for (int c = threadIdx.x * 8; c < v; c += kThreads * 8) {
      float vals[8];
      ff::load8(x + c, vals);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        vals[e] = expf(vals[e] - ls) * g - (c + e == lab ? gn : 0.f);
      }
      ff::store8(dx + c, vals);
    }
  } else {
    for (int c = threadIdx.x; c < v; c += kThreads) {
      const float p = expf(ff::to_float(x[c]) - ls);
      dx[c] = ff::from_float<T>(p * g - (c == lab ? gn : 0.f));
    }
  }
}

template <typename T>
cudaError_t fwd(const void* logits, const int* labels, float* nll, float* lse,
                int* pred, int n, int v, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  if (v % 8 == 0)
    xent_fwd_kernel<T, true><<<n, kThreads, 0, s>>>(x, labels, nll, lse, pred, v);
  else
    xent_fwd_kernel<T, false><<<n, kThreads, 0, s>>>(x, labels, nll, lse, pred, v);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* logits, const int* labels, const float* lse,
                const float* g_nll, const float* g_lse, void* dlogits, int n,
                int v, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  T* dx = static_cast<T*>(dlogits);
  if (v % 8 == 0)
    xent_bwd_kernel<T, true><<<n, kThreads, 0, s>>>(x, labels, lse, g_nll, g_lse, dx, v);
  else
    xent_bwd_kernel<T, false><<<n, kThreads, 0, s>>>(x, labels, lse, g_nll, g_lse, dx, v);
  return cudaGetLastError();
}

}  // namespace

// logits: (n, v) contiguous, 16-byte aligned, dtype ff::kFloat32 or
// ff::kBFloat16; labels: (n,) int32; nll, lse: (n,) f32; pred: (n,) int32.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ff_xent_fwd(const void* logits, const void* labels, void* nll,
                           void* lse, void* pred, int n, int v, int dtype,
                           void* stream) {
  if (n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* nll_f = static_cast<float*>(nll);
  float* lse_f = static_cast<float*>(lse);
  int* pred_i = static_cast<int*>(pred);
  if (dtype == ff::kFloat32)
    return (int)fwd<float>(logits, lab, nll_f, lse_f, pred_i, n, v, s);
  if (dtype == ff::kBFloat16)
    return (int)fwd<__nv_bfloat16>(logits, lab, nll_f, lse_f, pred_i, n, v, s);
  return (int)cudaErrorInvalidValue;
}

// logits, dlogits: (n, v) of one type, as above; labels: (n,) int32; lse:
// (n,) f32 from the forward; g_nll, g_lse: (n,) f32 cotangents, either may
// be null (zero).  Returns the launch's cudaError_t (0 = launched).
extern "C" int ff_xent_bwd(const void* logits, const void* labels,
                           const void* lse, const void* g_nll,
                           const void* g_lse, void* dlogits, int n, int v,
                           int dtype, void* stream) {
  if (n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* lse_f = static_cast<const float*>(lse);
  const float* gn = static_cast<const float*>(g_nll);
  const float* gl = static_cast<const float*>(g_lse);
  if (dtype == ff::kFloat32)
    return (int)bwd<float>(logits, lab, lse_f, gn, gl, dlogits, n, v, s);
  if (dtype == ff::kBFloat16)
    return (int)bwd<__nv_bfloat16>(logits, lab, lse_f, gn, gl, dlogits, n, v, s);
  return (int)cudaErrorInvalidValue;
}
