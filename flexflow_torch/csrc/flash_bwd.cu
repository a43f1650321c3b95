// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels flexflow_tpu/ops/pallas_kernels.py::_dq_kernel and
// ::_dkv_kernel (launched by _bwd_call, the VJP of flash_attention_lse), and
// the delta preprocess _cotangent_delta_lanes.  Given q, k, v, the forward's
// o and lse, the output cotangent do and the optional lse cotangent g_lse:
//
//   delta = rowsum(o * do) - g_lse                      (f32)
//   p     = exp(s * scale - lse),  s = q k^T            (recomputed, f32)
//   ds    = p * (do v^T - delta)
//   dq    = scale * ds k,  dk = scale * ds^T q,  dv = p^T do
//
// The cast points are the reference's: products of input-type operands
// accumulated in f32, the scale applied after the dot, p and ds rounded to
// the operand type before their products (p.astype(do.dtype) for dv,
// ds.astype(k/q.dtype) for dq/dk), dq/dk/dv accumulated in f32 and written
// in the input type.
//
// Design.  Two passes with no atomics, both 128-thread CTAs over 64-row
// tiles staged through shared memory as f32, the layout of flash_fwd.cu
// (16 row groups x 8 lanes; a thread owns 4 rows and 8 strided columns of
// a 64 x 64 score tile and 4 rows x hd/8 columns of its accumulator):
//   1. dq: one CTA per (bh, 64-row q tile).  It first computes delta for
//      its rows from o and do (and g_lse), writes it to the delta buffer,
//      then streams the k/v tiles up to the causal diagonal.
//   2. dk/dv: one CTA per (bh, 64-key tile), launched after pass 1 on the
//      same stream (it reads pass 1's delta); it streams the q/do tiles
//      from the diagonal down and computes the transposed score tile
//      s^T = k q^T directly, so no reduction crosses threads.
// Rows past t (a ragged last tile) are zero-filled and masked, so every
// t >= 1 runs; the causal loops skip the tiles above the diagonal.
//
// Bound.  Seven t x t x hd products (three in pass 1, four in pass 2) on
// the FMA pipes in f32: at long t the kernel is bound by operations, far
// below the bf16 tensor-core roofline.  wgmma/TMA tiles are the later fix.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;     // q and k tile edge
constexpr int kThreads = 128;  // 16 row groups x 8 lanes
constexpr int kRows = 4;       // tile rows per thread
constexpr int kCols = 8;       // score-tile columns per thread
constexpr int kPLd = kBlock + 1;

// Pass 1: dq and delta.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ g_lse, float* __restrict__ delta,
                T* __restrict__ dq, int t, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                   // kBlock x ld
  float* dos = qs + kBlock * ld;      // kBlock x ld
  float* ks = dos + kBlock * ld;      // kBlock x ld
  float* vs = ks + kBlock * ld;       // kBlock x ld
  float* dss = vs + kBlock * ld;      // kBlock x kPLd
  float* lse_s = dss + kBlock * kPLd; // kBlock
  float* delta_s = lse_s + kBlock;    // kBlock

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlock;
  const size_t slab = (size_t)bh * t * hd;
  const size_t row_base = (size_t)bh * t;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const int nj = hd / 8;

  ff::load_tile(qs, q + slab, q0, kBlock, t, hd, ld);
  ff::load_tile(dos, dout + slab, q0, kBlock, t, hd, ld);
  __syncthreads();

  // delta for this tile's rows: each row group reduces its 4 rows over its
  // 8 lanes (o read once from global memory, do from the staged tile).
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < t) {
      const T* orow = o + slab + (size_t)qp * hd;
      for (int d = tx; d < hd; d += 8) acc = fmaf(ff::to_float(orow[d]), dos[r * ld + d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tx == 0) {
      float dl = 0.f, ls = 0.f;
      if (qp < t) {
        dl = acc - (g_lse != nullptr ? g_lse[row_base + qp] : 0.f);
        ls = lse[row_base + qp];
        delta[row_base + qp] = dl;
      }
      delta_s[r] = dl;
      lse_s[r] = ls;
    }
  }

  float acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int kend = causal ? min(t, q0 + kBlock) : t;
  for (int k0 = 0; k0 < kend; k0 += kBlock) {
    const int kn = min(kBlock, kend - k0);
    __syncthreads();  // the previous tile's readers are done with ks/vs/dss
    ff::load_tile(ks, k + slab, k0, kn, t, hd, ld);
    ff::load_tile(vs, v + slab, k0, kn, t, hd, ld);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], dv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = qs[(ty * kRows + i) * ld + d];
        dv[i] = dos[(ty * kRows + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const float kv = c < kn ? ks[c * ld + d] : 0.f;
        const float vv = c < kn ? vs[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          s[i][j] = fmaf(qv[i], kv, s[i][j]);
          dp[i][j] = fmaf(dv[i], vv, dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qp = q0 + r;
      const float ls = lse_s[r], dl = delta_s[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool masked = kp >= kend || (causal && kp > qp);
        const float p = masked ? 0.f : expf(s[i][j] * scale - ls);
        dss[r * kPLd + tx + 8 * j] = ff::round_through<T>(p * (dp[i][j] - dl));
      }
    }
    __syncthreads();  // dss complete

    for (int c = 0; c < kn; ++c) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = dss[(ty * kRows + i) * kPLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float kv = ks[c * ld + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty * kRows + i;
    if (qp >= t) continue;
    T* row = dq + slab + (size_t)qp * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) row[tx + 8 * j] = ff::from_float<T>(acc[i][j] * scale);
    }
  }
}

// Pass 2: dk and dv.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int t, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* ks = smem;                     // kBlock x ld
  float* vs = ks + kBlock * ld;         // kBlock x ld
  float* qs = vs + kBlock * ld;         // kBlock x ld
  float* dos = qs + kBlock * ld;        // kBlock x ld
  float* pts = dos + kBlock * ld;       // kBlock x kPLd: p^T, rounded
  float* dsts = pts + kBlock * kPLd;    // kBlock x kPLd: ds^T, rounded
  float* lse_s = dsts + kBlock * kPLd;  // kBlock
  float* delta_s = lse_s + kBlock;      // kBlock

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  const size_t slab = (size_t)bh * t * hd;
  const size_t row_base = (size_t)bh * t;
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  const int nj = hd / 8;

  ff::load_tile(ks, k + slab, k0, kBlock, t, hd, ld);
  ff::load_tile(vs, v + slab, k0, kBlock, t, hd, ld);

  float adk[kRows][NJ], adv[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // Query tiles that see this key tile: all, or from the diagonal on.
  for (int q0 = causal ? k0 : 0; q0 < t; q0 += kBlock) {
    const int qn = min(kBlock, t - q0);
    __syncthreads();  // the previous tile's readers are done with qs/dos/pts
    ff::load_tile(qs, q + slab, q0, qn, t, hd, ld);
    ff::load_tile(dos, dout + slab, q0, qn, t, hd, ld);
    if (threadIdx.x < kBlock) {
      const int r = threadIdx.x;
      lse_s[r] = r < qn ? lse[row_base + q0 + r] : 0.f;
      delta_s[r] = r < qn ? delta[row_base + q0 + r] : 0.f;
    }
    __syncthreads();

    float st[kRows][kCols], dpt[kRows][kCols];  // [key row][query column]
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kv[kRows], vv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = ks[(ty * kRows + i) * ld + d];
        vv[i] = vs[(ty * kRows + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const float qv = c < qn ? qs[c * ld + d] : 0.f;
        const float dov = c < qn ? dos[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          st[i][j] = fmaf(kv[i], qv, st[i][j]);
          dpt[i][j] = fmaf(vv[i], dov, dpt[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int kp = k0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 8 * j;
        const bool masked = c >= qn || kp >= t || (causal && kp > q0 + c);
        const float p = masked ? 0.f : expf(st[i][j] * scale - lse_s[c]);
        pts[r * kPLd + c] = ff::round_through<T>(p);
        dsts[r * kPLd + c] = ff::round_through<T>(p * (dpt[i][j] - delta_s[c]));
      }
    }
    __syncthreads();  // pts/dsts complete

    for (int c = 0; c < qn; ++c) {
      float pv[kRows], dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = pts[(ty * kRows + i) * kPLd + c];
        dsv[i] = dsts[(ty * kRows + i) * kPLd + c];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float dov = dos[c * ld + tx + 8 * j];
          const float qv = qs[c * ld + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            adv[i][j] = fmaf(pv[i], dov, adv[i][j]);
            adk[i][j] = fmaf(dsv[i], qv, adk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kp = k0 + ty * kRows + i;
    if (kp >= t) continue;
    T* krow = dk + slab + (size_t)kp * hd;
    T* vrow = dv + slab + (size_t)kp * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        krow[tx + 8 * j] = ff::from_float<T>(adk[i][j] * scale);
        vrow[tx + 8 * j] = ff::from_float<T>(adv[i][j]);
      }
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, const float* g_lse,
                   float* delta, void* dq, void* dk, void* dv, int bh, int t,
                   int hd, int causal, float scale, cudaStream_t stream) {
  const size_t tile = (size_t)kBlock * (hd + 1);
  const size_t ptile = (size_t)kBlock * kPLd;
  const size_t smem_dq = sizeof(float) * (4 * tile + ptile + 2 * kBlock);
  const size_t smem_dkv = sizeof(float) * (4 * tile + 2 * ptile + 2 * kBlock);
  // Above 48 KB dynamic shared memory needs an opt-in per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_kernel<T, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlock - 1) / kBlock);
  flash_dq_kernel<T, NJ><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, g_lse, delta, static_cast<T*>(dq), t,
      hd, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, NJ><<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), t, hd, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     const float* g_lse, float* delta, void* dq, void* dk,
                     void* dv, int bh, int t, int hd, int causal, float scale,
                     cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 4>(q, k, v, o, dout, lse, g_lse, delta, dq, dk, dv, bh, t, hd, causal, scale, s);
  if (hd <= 64)
    return launch<T, 8>(q, k, v, o, dout, lse, g_lse, delta, dq, dk, dv, bh, t, hd, causal, scale, s);
  if (hd <= 96)
    return launch<T, 12>(q, k, v, o, dout, lse, g_lse, delta, dq, dk, dv, bh, t, hd, causal, scale, s);
  return launch<T, 16>(q, k, v, o, dout, lse, g_lse, delta, dq, dk, dv, bh, t, hd, causal, scale, s);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (bh, t, hd) contiguous, 16-byte aligned, of
// one type (dtype: ff::kFloat32 or ff::kBFloat16); lse, delta: (bh, t) f32;
// g_lse: (bh, t) f32 or null (no lse cotangent).  delta is scratch that the
// first pass writes and the second reads.  hd a multiple of 8 in [8, 128].
// Launches both passes on the stream; returns the first cudaError_t (0 =
// both launched).
extern "C" int ff_flash_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            const void* g_lse, void* delta, void* dq, void* dk,
                            void* dv, int bh, int t, int hd, int causal,
                            float scale, int dtype, void* stream) {
  if (bh < 1 || t < 1 || (t + kBlock - 1) / kBlock > 65535 || hd < 8 ||
      hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* g_f = static_cast<const float*>(g_lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == ff::kFloat32)
    return (int)dispatch<float>(q, k, v, o, dout, lse_f, g_f, delta_f, dq, dk,
                                dv, bh, t, hd, causal, scale, s);
  if (dtype == ff::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, dout, lse_f, g_f, delta_f,
                                        dq, dk, dv, bh, t, hd, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
