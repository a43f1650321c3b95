// Warp-level tile machinery of the race's flash kernels (flash_probe.cu,
// flash_probe_bwd.cu) and of the f32 streamed kernels (flash_stream.cu):
// cp.async tile loads into padded shared rows, mma.sync.m16n8k16 products
// whose f32 accumulators keep the documented fragment layout (the race's
// bf16 instantiations), and the f32 instantiation of the same products on
// the FMA pipes.
//
// CTAs are 4 warps (kThreads); a warp owns 16 rows of a resident tile, so
// kBM = 64 rows per CTA.  Fragment layout of a warp's 16 x N f32
// accumulator (mma.m16n8k16's C): acc[nt][e] is row g + 8 (e >> 1), column
// nt * 8 + 2 tq + (e & 1), with g = lane / 4 and tq = lane % 4, so the four
// threads of a quad (same g) hold one row pair between them.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// acc (16 x N) += A (16 x K, row-major, pitch lda) . B^T, B (N x K,
// row-major, pitch ldb): both operands in shared memory.
template <int K, int N>
__device__ __forceinline__ void warp_abt(float (*acc)[4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[4];
    af[0] = ld32(a + g * lda + kk + 2 * tq);
    af[1] = ld32(a + (g + 8) * lda + kk + 2 * tq);
    af[2] = ld32(a + g * lda + kk + 8 + 2 * tq);
    af[3] = ld32(a + (g + 8) * lda + kk + 8 + 2 * tq);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const __nv_bfloat16* br = b + (nt * 8 + g) * ldb + kk + 2 * tq;
      mma_bf16(acc[nt], af, ld32(br), ld32(br + 8));
    }
  }
}

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

// acc (16 x HD) += P (16 x N, an f32 accumulator in fragment layout,
// rounded to the operand type here) . V (N x HD, row-major in shared
// memory, pitch ldv).  bf16: P stays in registers as the A operand and V
// is read transposed by ldmatrix.  f32: P goes through the warp's shared
// tile pbuf (16 x (N + 4)).
template <int N, int HD>
__device__ __forceinline__ void warp_pv(float (*acc)[4], const float (*p)[4],
                                        const __nv_bfloat16* v, int ldv,
                                        float* /*pbuf*/) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t af[4];
    af[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    af[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    af[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    af[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* vrow = v + (kk * 16 + r8 + (mi & 1) * 8) * ldv + (mi >> 1) * 8;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, vrow + np * 16);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

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

template <typename T>
__host__ __device__ constexpr int pbuf_floats(int n) {
  return sizeof(T) == 4 ? kWarps * 16 * (n + 4) : 0;
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
