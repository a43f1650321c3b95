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
// Bound.  Bytes: the forward reads the logits once (N*V*itemsize), the
// backward reads them and writes dlogits once; both are far below the
// card's operation rate.  At a classifier's class count (V = 1000, a 2 KB
// bf16 row) the bytes take about a microsecond, so there the kernel is
// bound by latency: the launch, one round trip to memory for the row, and
// the reduction's dependent steps.
//
// Design.  Two forms; the caller picks one (kernels._xent_form, from the
// forms' measured crossover) and passes it as `lanes`.  Both read vectors
// when V % 8 == 0 and single elements otherwise.
//
// Row groups (lanes = 8, 16 or 32: short rows).  A group of `lanes` lanes
// of one warp owns a row and a 256-thread CTA holds 256 / lanes rows; the
// grid is at most one wave (kRowsCtasPerSm CTAs per SM) and walks the rows
// beyond it.  A vector is 16 bytes (8 bf16 or 4 f32 elements), so a warp's
// load covers 512 contiguous bytes.  A lane's vectors interleave across
// the row at a stride of `lanes` vectors, so its registers hold increasing
// indices.  Each lane first issues every load of a register tile (R = 8,
// 16 or 32 values: the whole of a 1000-class bf16 row in one warp, 4
// vectors a lane) beside labels[row]; then it takes the tile's max and
// first argmax (strict '>'), sum exp(x - m) over its registers (ex2.approx:
// the sum needs no more) and, if it holds it, x[label].  A row
// longer than a tile is walked tile by tile, with the online max / sum
// rescale between tiles only.  The group merges by __shfl_xor_sync alone,
// with no shared memory and no __syncthreads: the max and its index (the
// smaller index on equal values), then the lane sums rescaled to the row
// max, then one shuffle brings x[label] from the lane that read it.  The
// backward uses the same groups: the row's scalars and the tile's vectors
// loaded first, one exp per element, vector stores.
//
// CTA per row (lanes = 0: long rows, the LM's 32768 classes).  One
// 256-thread CTA per row; each thread streams its strided vectors of 8
// elements (one 16-byte load for bf16, two for f32) keeping
// an online max / sum-exp pair and a running argmax that moves only on a
// strict '>', and keeps x[label] when it reads it (labels[row] is loaded
// first); the CTA merges the pairs with warp shuffles and shared memory,
// preferring the smaller index on equal values.  The backward walks the
// row the same way, one exp per element, written back in place of the read.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Row groups: the CTAs of 256 threads one SM holds at once, which
// __launch_bounds__ guarantees (at most 64 registers a thread); the grid is
// at most this many CTAs per SM.
constexpr int kRowsCtasPerSm = 4;

// ---------------------------------------------------------------------------
// CTA per row
// ---------------------------------------------------------------------------

struct Stat {
  float m;    // running max
  float l;    // sum of exp(x - m)
  float bv;   // argmax value
  int bi;     // argmax index (first among equal values)
};

__device__ __forceinline__ Stat merge(const Stat& a, const Stat& b) {
  Stat r;
  r.m = fmaxf(a.m, b.m);
  r.l = a.l * __expf(a.m - r.m) + b.l * __expf(b.m - r.m);
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
    st.l *= __expf(st.m - cm);
    st.m = cm;
  }
  for (int e = 0; e < n; ++e) st.l += __expf(x[e] - st.m);
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
  __shared__ float target;  // x[label], written by the thread that reads it
  const size_t row = blockIdx.x;
  const T* x = logits + row * (size_t)v;
  const int lab = labels[row];
  Stat st{ff::kNegInf, 0.f, -INFINITY, 0};
  if (VEC) {
    for (int c = threadIdx.x * 8; c < v; c += kThreads * 8) {
      float vals[8];
      ff::load8(x + c, vals);
      absorb(st, vals, 8, c);
      if ((unsigned)(lab - c) < 8u) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (c + e == lab) target = vals[e];
        }
      }
    }
  } else {
    for (int c = threadIdx.x; c < v; c += kThreads) {
      const float val = ff::to_float(x[c]);
      absorb(st, &val, 1, c);
      if (c == lab) target = val;
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
    lse[row] = ls;
    nll[row] = (lab >= 0 && lab < v) ? ls - target : NAN;
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

// ---------------------------------------------------------------------------
// Row groups
// ---------------------------------------------------------------------------

// The row index of register i of `lane` in the tile at `base`: the lane's
// vector i / W is vector (i / W) * L + lane of the tile.
template <int W, int L>
__device__ __forceinline__ int elem(int base, int lane, int i) {
  return base + ((i / W) * L + lane) * W + i % W;
}

// One 16-byte vector (W = 4 f32 or 8 bf16 elements) as f32, and back.
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  ff::load8(p, out);
}
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  ff::store8(p, in);
}

// The lane's R values of the tile at `base` of a row of v elements, in W
// wide vectors (16 bytes, or single elements); values past the row read
// as -inf.
template <typename T, int W, int L, int R>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, int base,
                                          int v, int lane, float (&r)[R]) {
#pragma unroll
  for (int k = 0; k < R / W; ++k) {
    const int c = elem<W, L>(base, lane, k * W);
    const bool in = c < v;  // the lane's vector k lies in the row
    if constexpr (W > 1) {
      if (in) {
        load_vec(x + c, &r[W * k]);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) r[W * k + e] = -INFINITY;
      }
    } else {
      r[k] = in ? ff::to_float(x[c]) : -INFINITY;
    }
  }
}

// 2^x by ex2.approx (about 2 ulp; flushes results below 2^-126 to 0).
// The forward's sum of exponentials needs no more: each term is
// ex2(x log2(e) - m log2(e)) from one FFMA, lse is held to 1e-4, and a
// flushed term is below 2^-126 of the row max's.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int W, int L, int R>
__global__ void __launch_bounds__(kThreads, kRowsCtasPerSm)
xent_rows_fwd_kernel(const T* __restrict__ logits,
                     const int* __restrict__ labels, float* __restrict__ nll,
                     float* __restrict__ lse, int* __restrict__ pred, int n,
                     int v) {
  constexpr int kRows = kThreads / L;
  constexpr int kTile = L * R;
  constexpr int kGroups = R / 8;  // runs of 8 registers, reduced apart
  const int lane = threadIdx.x % L;
  // Every lane of a warp takes the same trips: its shuffles need them all.
  for (int r0 = blockIdx.x * kRows; r0 < n; r0 += gridDim.x * kRows) {
    const int row = r0 + threadIdx.x / L;
    const bool live = row < n;
    const int vr = live ? v : 0;  // a group past the last row reads nothing
    const T* x = logits + (size_t)(live ? row : 0) * v;
    const int lab = live ? labels[row] : -1;
    float m = ff::kNegInf, l = 0.f, t = 0.f;
    int bi = 0;
    for (int base = 0; base < v; base += kTile) {
      float r[R];
      load_tile<T, W, L, R>(x, base, vr, lane, r);
      // Each run's max and first index, then the runs in order.
      float gm[kGroups];
      int gi[kGroups];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        gm[q] = r[8 * q];
        gi[q] = 8 * q;
#pragma unroll
        for (int e = 1; e < 8; ++e) {
          if (r[8 * q + e] > gm[q]) {
            gm[q] = r[8 * q + e];
            gi[q] = 8 * q + e;
          }
        }
      }
      float cm = gm[0];
      int ci = gi[0];
#pragma unroll
      for (int q = 1; q < kGroups; ++q) {
        if (gm[q] > cm) {
          cm = gm[q];
          ci = gi[q];
        }
      }
      if (cm > m) {  // the tiles before hold no value as large
        l *= __expf(m - cm);
        m = cm;
        bi = elem<W, L>(base, lane, ci);
      }
      const float ml = m * kLog2e;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part += ex2(fmaf(r[8 * q + e], kLog2e, -ml));
        l += part;
      }
#pragma unroll
      for (int k = 0; k < R / W; ++k) {
        const int c = elem<W, L>(base, lane, k * W);
        if ((unsigned)(lab - c) < (unsigned)W) {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            if (c + e == lab) t = r[k * W + e];
          }
        }
      }
    }
    float mx = m;
    int ix = bi;
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx, off, L);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, off, L);
      const bool take = om > mx || (om == mx && oi < ix);
      mx = take ? om : mx;
      ix = take ? oi : ix;
    }
    float s = l * __expf(m - mx);
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off, L);
    }
    const int owner = (int)(((unsigned)lab / W) % L);
    const float target = __shfl_sync(0xffffffffu, t, owner, L);
    if (live && lane == 0) {
      const float ls = mx + logf(s);
      lse[row] = ls;
      nll[row] = (lab >= 0 && lab < v) ? ls - target : NAN;
      pred[row] = ix;
    }
  }
}

template <typename T, int W, int L, int R>
__global__ void __launch_bounds__(kThreads, kRowsCtasPerSm)
xent_rows_bwd_kernel(const T* __restrict__ logits,
                     const int* __restrict__ labels,
                     const float* __restrict__ lse,
                     const float* __restrict__ g_nll,
                     const float* __restrict__ g_lse, T* __restrict__ dlogits,
                     int n, int v) {
  constexpr int kRows = kThreads / L;
  constexpr int kTile = L * R;
  const int lane = threadIdx.x % L;
  for (int row = blockIdx.x * kRows + threadIdx.x / L; row < n;
       row += gridDim.x * kRows) {
    const T* x = logits + (size_t)row * v;
    T* dx = dlogits + (size_t)row * v;
    const int lab = labels[row];
    const float ls = lse[row];
    const float gn = g_nll != nullptr ? g_nll[row] : 0.f;
    const float g = gn + (g_lse != nullptr ? g_lse[row] : 0.f);
    for (int base = 0; base < v; base += kTile) {
      float r[R];
      load_tile<T, W, L, R>(x, base, v, lane, r);
#pragma unroll
      for (int k = 0; k < R / W; ++k) {
        const int c = elem<W, L>(base, lane, k * W);
        if (c >= v) continue;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int i = k * W + e;
          r[i] = expf(r[i] - ls) * g - (c + e == lab ? gn : 0.f);
        }
        if constexpr (W > 1) {
          store_vec(dx + c, &r[W * k]);
        } else {
          dx[c] = ff::from_float<T>(r[k]);
        }
      }
    }
  }
}

// The grid of the row-group form: a CTA per 256 / lanes rows, at most one
// wave of kRowsCtasPerSm CTAs per SM.
int rows_grid(int n, int lanes) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rows = kThreads / lanes;
  const int ctas = (n + rows - 1) / rows;
  return ctas < sms * kRowsCtasPerSm ? ctas : sms * kRowsCtasPerSm;
}

// The register tile R of a lane: 8 values for groups of 8 and 16 lanes;
// for a warp the least of 8, 16 and 32 that holds the row, else 32 (a
// tile of 1024 elements, walked).
template <typename T, int W>
cudaError_t rows_fwd(const T* x, const int* labels, float* nll, float* lse,
                     int* pred, int n, int v, int lanes, cudaStream_t s) {
  const int grid = rows_grid(n, lanes);
  if (lanes == 8)
    xent_rows_fwd_kernel<T, W, 8, 8><<<grid, kThreads, 0, s>>>(x, labels, nll, lse, pred, n, v);
  else if (lanes == 16)
    xent_rows_fwd_kernel<T, W, 16, 8><<<grid, kThreads, 0, s>>>(x, labels, nll, lse, pred, n, v);
  else if (lanes == 32 && v <= 256)
    xent_rows_fwd_kernel<T, W, 32, 8><<<grid, kThreads, 0, s>>>(x, labels, nll, lse, pred, n, v);
  else if (lanes == 32 && v <= 512)
    xent_rows_fwd_kernel<T, W, 32, 16><<<grid, kThreads, 0, s>>>(x, labels, nll, lse, pred, n, v);
  else if (lanes == 32)
    xent_rows_fwd_kernel<T, W, 32, 32><<<grid, kThreads, 0, s>>>(x, labels, nll, lse, pred, n, v);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t rows_bwd(const T* x, const int* labels, const float* lse,
                     const float* gn, const float* gl, T* dx, int n, int v,
                     int lanes, cudaStream_t s) {
  const int grid = rows_grid(n, lanes);
  if (lanes == 8)
    xent_rows_bwd_kernel<T, W, 8, 8><<<grid, kThreads, 0, s>>>(x, labels, lse, gn, gl, dx, n, v);
  else if (lanes == 16)
    xent_rows_bwd_kernel<T, W, 16, 8><<<grid, kThreads, 0, s>>>(x, labels, lse, gn, gl, dx, n, v);
  else if (lanes == 32 && v <= 256)
    xent_rows_bwd_kernel<T, W, 32, 8><<<grid, kThreads, 0, s>>>(x, labels, lse, gn, gl, dx, n, v);
  else if (lanes == 32 && v <= 512)
    xent_rows_bwd_kernel<T, W, 32, 16><<<grid, kThreads, 0, s>>>(x, labels, lse, gn, gl, dx, n, v);
  else if (lanes == 32)
    xent_rows_bwd_kernel<T, W, 32, 32><<<grid, kThreads, 0, s>>>(x, labels, lse, gn, gl, dx, n, v);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* logits, const int* labels, float* nll, float* lse,
                int* pred, int n, int v, int lanes, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  const bool vec = v % 8 == 0;
  if (lanes != 0) {
    constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
    return vec ? rows_fwd<T, kVec>(x, labels, nll, lse, pred, n, v, lanes, s)
               : rows_fwd<T, 1>(x, labels, nll, lse, pred, n, v, lanes, s);
  }
  if (vec)
    xent_fwd_kernel<T, true><<<n, kThreads, 0, s>>>(x, labels, nll, lse, pred, v);
  else
    xent_fwd_kernel<T, false><<<n, kThreads, 0, s>>>(x, labels, nll, lse, pred, v);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* logits, const int* labels, const float* lse,
                const float* g_nll, const float* g_lse, void* dlogits, int n,
                int v, int lanes, cudaStream_t s) {
  const T* x = static_cast<const T*>(logits);
  T* dx = static_cast<T*>(dlogits);
  const bool vec = v % 8 == 0;
  if (lanes != 0) {
    constexpr int kVec = 16 / sizeof(T);
    return vec ? rows_bwd<T, kVec>(x, labels, lse, g_nll, g_lse, dx, n, v, lanes, s)
               : rows_bwd<T, 1>(x, labels, lse, g_nll, g_lse, dx, n, v, lanes, s);
  }
  if (vec)
    xent_bwd_kernel<T, true><<<n, kThreads, 0, s>>>(x, labels, lse, g_nll, g_lse, dx, v);
  else
    xent_bwd_kernel<T, false><<<n, kThreads, 0, s>>>(x, labels, lse, g_nll, g_lse, dx, v);
  return cudaGetLastError();
}

}  // namespace

// logits: (n, v) contiguous, 16-byte aligned, dtype ff::kFloat32 or
// ff::kBFloat16; labels: (n,) int32; nll, lse: (n,) f32; pred: (n,) int32;
// lanes: the form, 0 for a CTA per row, else 8, 16 or 32 lanes per row.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ff_xent_fwd(const void* logits, const void* labels, void* nll,
                           void* lse, void* pred, int n, int v, int dtype,
                           int lanes, void* stream) {
  if (n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* nll_f = static_cast<float*>(nll);
  float* lse_f = static_cast<float*>(lse);
  int* pred_i = static_cast<int*>(pred);
  if (dtype == ff::kFloat32)
    return (int)fwd<float>(logits, lab, nll_f, lse_f, pred_i, n, v, lanes, s);
  if (dtype == ff::kBFloat16)
    return (int)fwd<__nv_bfloat16>(logits, lab, nll_f, lse_f, pred_i, n, v,
                                   lanes, s);
  return (int)cudaErrorInvalidValue;
}

// logits, dlogits: (n, v) of one type, as above; labels: (n,) int32; lse:
// (n,) f32 from the forward; g_nll, g_lse: (n,) f32 cotangents, either may
// be null (zero); lanes: the form, as above.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int ff_xent_bwd(const void* logits, const void* labels,
                           const void* lse, const void* g_nll,
                           const void* g_lse, void* dlogits, int n, int v,
                           int dtype, int lanes, void* stream) {
  if (n < 1 || v < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* lse_f = static_cast<const float*>(lse);
  const float* gn = static_cast<const float*>(g_nll);
  const float* gl = static_cast<const float*>(g_lse);
  if (dtype == ff::kFloat32)
    return (int)bwd<float>(logits, lab, lse_f, gn, gl, dlogits, n, v, lanes, s);
  if (dtype == ff::kBFloat16)
    return (int)bwd<__nv_bfloat16>(logits, lab, lse_f, gn, gl, dlogits, n, v,
                                   lanes, s);
  return (int)cudaErrorInvalidValue;
}
