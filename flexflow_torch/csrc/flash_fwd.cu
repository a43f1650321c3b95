// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_kernels.py::_fwd_kernel
// (launched by _fwd_call, reached through flash_attention_lse).  Same
// function: softmax(q k^T / sqrt(hd)) v over (bh, t, hd) slabs, causal or
// not, returning o in the input type and lse = m + log(l) in f32.  The cast
// points are the reference's: scores in f32, the scale applied after the
// dot, p rounded to v's type before P.V, l summed from the f32 p.
//
// Design.  One CTA of 128 threads per (bh, 64-row q tile); K/V stream
// through shared memory in 64-key tiles with the running (m, l, acc) kept in
// f32 registers.  The 128 threads form 16 row groups x 8 lanes: a thread
// owns 4 query rows and, for the score tile, 8 key columns (strided by 8 so
// the lanes of a row group hit different banks); a row's max and sum are
// reduced over its 8 lanes with warp shuffles.  The causal loop stops at the
// diagonal tile, and only keys past a row's position (or past t) are masked,
// so every t >= 1 is supported.  Products run on the FMA pipes in f32.
//
// Bound.  At long t the kernel is bound by the matrix products (tensor-core
// FLOPs on a kernel that uses them); at the serving prefill's t <= 128 it is
// bound by launch latency and the one-CTA-per-tile parallelism, far from
// both rooflines.  wgmma/TMA tiles are the later fix.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = 8;       // key columns per thread in a score tile
constexpr int kPLd = kBlockK + 1;

// NJ bounds the head dim: hd <= 8 * NJ (the per-thread accumulator columns).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int t, int hd, int causal,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                  // kBlockQ x ld
  float* ks = qs + kBlockQ * ld;     // kBlockK x ld
  float* vs = ks + kBlockK * ld;     // kBlockK x ld
  float* ps = vs + kBlockK * ld;     // kBlockQ x kPLd

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const size_t slab = (size_t)bh * t * hd;
  const int ty = threadIdx.x / 8;  // row group: rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 8;  // lane within the row group
  const int nj = hd / 8;

  ff::load_tile(qs, q + slab, q0, kBlockQ, t, hd, ld);

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = ff::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // Keys this tile needs: all of them, or up to its last row when causal.
  const int kend = causal ? min(t, q0 + kBlockQ) : t;
  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    const int kn = min(kBlockK, kend - k0);
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    ff::load_tile(ks, k + slab, k0, kn, t, hd, ld);
    ff::load_tile(vs, v + slab, k0, kn, t, hd, ld);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const float kv = c < kn ? ks[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i;
      float mx = ff::kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool masked = kp >= kend || (causal && kp > qp);
        s[i][j] = masked ? ff::kNegInf : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty * kRows + i) * kPLd + tx + 8 * j] = ff::round_through<T>(p);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // ps complete

    for (int c = 0; c < kn; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * kPLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float vv = vs[c * ld + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= t) continue;
    T* orow = o + slab + (size_t)qp * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) orow[tx + 8 * j] = ff::from_float<T>(acc[i][j] / l[i]);
    }
    if (tx == 0) lse[(size_t)bh * t + qp] = m[i] + logf(l[i]);
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int t, int hd, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBlockQ + 2 * kBlockK) * (hd + 1) +
                       (size_t)kBlockQ * kPLd);
  // Above 48 KB dynamic shared memory needs an opt-in per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, t, hd, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int t, int hd, int causal,
                     float scale, cudaStream_t stream) {
  if (hd <= 32) return launch<T, 4>(q, k, v, o, lse, bh, t, hd, causal, scale, stream);
  if (hd <= 64) return launch<T, 8>(q, k, v, o, lse, bh, t, hd, causal, scale, stream);
  if (hd <= 96) return launch<T, 12>(q, k, v, o, lse, bh, t, hd, causal, scale, stream);
  return launch<T, 16>(q, k, v, o, lse, bh, t, hd, causal, scale, stream);
}

}  // namespace

// q, k, v, o: (bh, t, hd) contiguous, 16-byte aligned, of one type (dtype:
// ff::kFloat32 or ff::kBFloat16); lse: (bh, t) f32.  hd a multiple of 8 in
// [8, 128].  Returns the launch's cudaError_t (0 = launched).
extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int t, int hd,
                            int causal, float scale, int dtype,
                            void* stream) {
  if (bh < 1 || t < 1 || (t + kBlockQ - 1) / kBlockQ > 65535 ||
      hd < 8 || hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == ff::kFloat32)
    return (int)dispatch<float>(q, k, v, o, lse_f, bh, t, hd, causal, scale, s);
  if (dtype == ff::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, lse_f, bh, t, hd, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
