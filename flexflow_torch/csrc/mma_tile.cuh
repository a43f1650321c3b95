// Warp-level tile machinery of the f32 flash kernels: the race's f32
// variants (flash_probe.cu, flash_probe_bwd.cu) and the f32 streamed
// kernels (flash_stream.cu).  cp.async tile loads into padded shared rows
// and products on the FMA pipes in f32 (wgmma takes f32 only as TF32).
// Every bf16 flash kernel runs on wgmma_tile.cuh instead.
//
// CTAs are 4 warps (kThreads); a warp owns 16 rows of a resident tile, so
// kBM = 64 rows per CTA.  The f32 accumulators keep the fragment layout of
// mma.m16n8k16's C, a warp's 16 x N: acc[nt][e] is row g + 8 (e >> 1),
// column nt * 8 + 2 tq + (e & 1), with g = lane / 4 and tq = lane % 4, so
// the four threads of a quad (same g) hold one row pair between them.
#pragma once

#include "common.cuh"

namespace ff {
namespace tile {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // resident rows per CTA: 16 per warp

// 16 bytes of padding per shared row: keeps rows 16-byte aligned for
// cp.async and ldmatrix, and spreads the rows of a fragment over the banks.
template <typename T>
__host__ __device__ constexpr int pitch(int hd) { return hd + 16 / (int)sizeof(T); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of a (t, HD) slab into shared memory (row pitch
// pitch<T>(HD)) by cp.async; rows at or past t are zero-filled.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void async_tile(T* dst, const T* src, int row0,
                                           int t) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = HD / kVec;
  constexpr int kLd = pitch<T>(HD);
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c - r * kPerRow) * kVec;
    const bool ok = row0 + r < t;
    cp_async16(dst + r * kLd + col,
               src + (size_t)(ok ? row0 + r : 0) * HD + col, ok);
  }
}

// n consecutive f32 row scalars (lse or delta) from row0; zero past t.
template <int N>
__device__ __forceinline__ void async_rows(float* dst, const float* src,
                                           int row0, int t) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool ok = row0 + i < t;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// acc (16 x N) += A (16 x K, row-major, pitch lda) . B^T, B (N x K,
// row-major, pitch ldb): both operands in shared memory.
template <int K, int N>
__device__ __forceinline__ void warp_abt(float (*acc)[4], const float* a,
                                         int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * lda + k], a1 = a[(g + 8) * lda + k];
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const float b0 = b[(nt * 8 + 2 * tq) * ldb + k];
      const float b1 = b[(nt * 8 + 2 * tq + 1) * ldb + k];
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

// acc (16 x HD) += P (16 x N, an f32 accumulator in fragment layout) . V
// (N x HD, row-major in shared memory, pitch ldv).  P goes through the
// warp's shared tile pbuf (16 x (N + 4)).
template <int N, int HD>
__device__ __forceinline__ void warp_pv(float (*acc)[4], const float (*p)[4],
                                        const float* v, int ldv, float* pbuf) {
  constexpr int kPl = N + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    pbuf[g * kPl + nt * 8 + 2 * tq] = p[nt][0];
    pbuf[g * kPl + nt * 8 + 2 * tq + 1] = p[nt][1];
    pbuf[(g + 8) * kPl + nt * 8 + 2 * tq] = p[nt][2];
    pbuf[(g + 8) * kPl + nt * 8 + 2 * tq + 1] = p[nt][3];
  }
  __syncwarp();
#pragma unroll 4
  for (int k = 0; k < N; ++k) {
    const float p0 = pbuf[g * kPl + k], p1 = pbuf[(g + 8) * kPl + k];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const float v0 = v[k * ldv + nt * 8 + 2 * tq];
      const float v1 = v[k * ldv + nt * 8 + 2 * tq + 1];
      acc[nt][0] = fmaf(p0, v0, acc[nt][0]);
      acc[nt][1] = fmaf(p0, v1, acc[nt][1]);
      acc[nt][2] = fmaf(p1, v0, acc[nt][2]);
      acc[nt][3] = fmaf(p1, v1, acc[nt][3]);
    }
  }
  __syncwarp();  // pbuf is rewritten by the warp's next product
}

// Floats of the P tiles of warp_pv (one 16 x (n + 4) tile per warp).
__host__ __device__ constexpr int pbuf_floats(int n) {
  return kWarps * 16 * (n + 4);
}

template <int NT>
__device__ __forceinline__ void zero(float (*a)[4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// Writes a warp's 16 x HD accumulator, times mul, to rows row0.. of a
// (t, HD) slab; rows at or past t are skipped.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, const float (*acc)[4],
                                           int row0, int t, float mul0,
                                           float mul1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= t) continue;
    const float mul = h ? mul1 : mul0;
    T* out = dst + (size_t)row * HD + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      out[nt * 8] = ff::from_float<T>(acc[nt][2 * h] * mul);
      out[nt * 8 + 1] = ff::from_float<T>(acc[nt][2 * h + 1] * mul);
    }
  }
}

// The most dynamic shared memory a CTA may opt into: 227 KB.
constexpr size_t kSmemMax = 232448;

// A ring of S (1 or 2) cp.async stages over tiles j = 0 .. n-1, where
// issue(j, st) queues tile j's copies into stage st.  The caller issues
// tile 0 into stage 0 and commits, then for each j calls ring_wait, computes
// on the returned stage and calls ring_done.
//
// Before tile j: with two stages, queue tile j + 1 into the other stage;
// wait for tile j.  Returns tile j's stage.
template <int S, typename Issue>
__device__ __forceinline__ int ring_wait(int j, int n, Issue issue) {
  const int st = S == 2 ? (j & 1) : 0;
  if (S == 2 && j + 1 < n) {
    issue(j + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
  } else {
    cp_wait<0>();
  }
  __syncthreads();
  return st;
}

// After computing tile j: every warp is done with its stage; with one
// stage, tile j + 1 is queued only now.
template <int S, typename Issue>
__device__ __forceinline__ void ring_done(int j, int n, Issue issue) {
  __syncthreads();
  if (S == 1 && j + 1 < n) {
    issue(j + 1, 0);
    cp_commit();
  }
}

}  // namespace tile
}  // namespace ff
