// Flash-forward variants of the kernel race (P1) for Hopper (sm_90a):
// three ways to keep the softmax bookkeeping of causal or non-causal
// attention over (bh, t, hd) slabs, computing o only (no lse).
//
// Replaces the TPU kernels of tools/probe_flash_variants.py (launched by
// _call, :204):
//   * _v2_kernel (:46), the row state: online softmax, acc = acc corr + p v,
//     l = l corr + sum p.  The TPU remedy was a layout of m and l that needs
//     no cross-lane broadcast per tile.  Here m and l live in every thread
//     that holds a part of the row (the quad of the m16n8k16 accumulator),
//     both reduced over the quad once per key tile, and the correction
//     multiplies the register accumulator once per key tile.
//   * _v3_kernel (:103), two passes: pass 1 the masked scores and the row
//     max, pass 2 p = exp(s - m), l = sum p and acc += p v with no
//     corrections at all.  The TPU staged s in a (block_q, t) f32 VMEM
//     scratch.  That does not fit 227 KB of shared memory (512 KB for a
//     64-row tile at t = 2048), so pass 2 recomputes the scores: s stays
//     out of device memory as on the TPU, at twice the Q.K^T products
//     (1.5x the forward's).  Staging s in a global workspace instead would
//     write and read 4 b h t^2 / 2 bytes (2.1 GB at the 2k training shape,
//     0.64 ms at 3.35 TB/s, more than K1f's whole time), while the
//     recomputed products are 0.035 ms of tensor-core time there.
//     Each thread keeps a running max of its own scores and the quad
//     reduces it once, after pass 1 ("one max per row"); l likewise after
//     pass 2.
//   * _v4_kernel (:174), the full row: one softmax over the whole masked
//     row, keys above the diagonal included (2x the causal products), with
//     no causal skip of key tiles.  A full row of scores fits neither the
//     registers nor shared memory at these t, so it is the two passes of
//     v3 over every key tile of the row, the mask applied per element.
//     Without a causal mask it is v3.
// The cast points are K1f's: f32 scores, the scale after the dot, the
// finite -1e30 mask, p rounded to v's type before P.V, l summed from the
// f32 p.
//
// Tile machinery (mma_tile.cuh, the race's own: the three variants share it
// so that the race compares formulations, not machinery).  One CTA of 4 warps per (bh, 64-row q
// tile), 16 query rows per warp; key tiles of BN (the race's block, 64 or
// 128) stream through a cp.async ring of two stages, or one where two do
// not fit shared memory (f32 at hd 128 and BN 128).  bf16 products run on
// the tensor cores (mma.sync.m16n8k16, f32 accumulation); the f32
// instantiation runs the same products on the FMA pipes, with no TF32.
//
// Bound.  At the race's shapes each variant is bound by its products:
// 4 b h hd t^2 / 2 FLOPs for the causal function (v3 spends 1.5x that, v4
// 3x).  mma.sync from shared-memory fragments issues at a fraction of the
// wgmma rate; these kernels measure the bookkeeping's share on the same
// machinery, and the K1 redesign takes the cheapest.
#include "mma_tile.cuh"

namespace {

using namespace ff::tile;

template <typename T, int HD, int BN>
__host__ __device__ constexpr size_t fwd_smem(int stages) {
  return sizeof(T) * (size_t)(kBM + 2 * stages * BN) * pitch<T>(HD) +
         sizeof(float) * pbuf_floats<T>(BN);
}

// Two cp.async stages when they fit, else one.
template <typename T, int HD, int BN>
__host__ __device__ constexpr int fwd_stages() {
  return fwd_smem<T, HD, BN>(2) <= kSmemMax ? 2 : 1;
}

// The scaled, masked scores of a warp's 16 rows against key tile k0..k0+BN.
template <typename T, int HD, int BN>
__device__ __forceinline__ void scores(float (*s)[4], const T* qw,
                                       const T* kt, int k0, const int* rows,
                                       int t, int causal, float scale) {
  constexpr int kLd = pitch<T>(HD);
  const int tq = (threadIdx.x & 31) & 3;
  zero<BN / 8>(s);
  warp_abt<HD, BN>(s, qw, kLd, kt, kLd);
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + 2 * tq + (e & 1);
      const bool masked = col >= t || (causal && col > rows[e >> 1]);
      s[nt][e] = masked ? ff::kNegInf : s[nt][e] * scale;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// v2: the row state
// ---------------------------------------------------------------------------

template <typename T, int HD, int BN>
__global__ void __launch_bounds__(kThreads)
row_state_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t,
                 int causal, float scale) {
  constexpr int S = fwd_stages<T, HD, BN>();
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* ks = qs + kBM * kLd;                  // S stages x BN x kLd
  T* vs = ks + S * BN * kLd;               // S stages x BN x kLd
  float* pbuf = reinterpret_cast<float*>(vs + S * BN * kLd);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  const size_t slab = (size_t)blockIdx.y * t * HD;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* qw = qs + warp * 16 * kLd;
  float* wbuf = pbuf + warp * 16 * (BN + 4);
  const int nk = ((causal ? min(t, q0 + kBM) : t) + BN - 1) / BN;
  auto issue = [&](int j, int st) {
    async_tile<T, HD, BN>(ks + st * BN * kLd, k + slab, j * BN, t);
    async_tile<T, HD, BN>(vs + st * BN * kLd, v + slab, j * BN, t);
  };
  async_tile<T, HD, kBM>(qs, q + slab, q0, t);
  issue(0, 0);
  cp_commit();

  // The row state, whole in each thread of the row's quad.
  float m[2] = {ff::kNegInf, ff::kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  zero<HD / 8>(acc);
  for (int j = 0; j < nk; ++j) {
    const int st = ring_wait<S>(j, nk, issue);
    float s[BN / 8][4];
    scores<T, HD, BN>(s, qw, ks + st * BN * kLd, j * BN, rows, t, causal,
                      scale);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(rs[h]);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
    warp_pv<BN, HD>(acc, s, vs + st * BN * kLd, kLd, wbuf);
    ring_done<S>(j, nk, issue);
  }
  store_rows<T, HD>(o + slab, acc, q0 + warp * 16, t, 1.f / l[0], 1.f / l[1]);
}

// ---------------------------------------------------------------------------
// v3 (SKIP: the causal loop stops at the diagonal) and v4 (every key tile)
// ---------------------------------------------------------------------------

template <typename T, int HD, int BN, bool SKIP>
__global__ void __launch_bounds__(kThreads)
two_pass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int t, int causal,
                float scale) {
  constexpr int S = fwd_stages<T, HD, BN>();
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* ks = qs + kBM * kLd;                  // S stages x BN x kLd
  T* vs = ks + S * BN * kLd;               // S stages x BN x kLd
  float* pbuf = reinterpret_cast<float*>(vs + S * BN * kLd);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const size_t slab = (size_t)blockIdx.y * t * HD;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* qw = qs + warp * 16 * kLd;
  float* wbuf = pbuf + warp * 16 * (BN + 4);
  const int nk = ((SKIP && causal ? min(t, q0 + kBM) : t) + BN - 1) / BN;
  auto issue_k = [&](int j, int st) {
    async_tile<T, HD, BN>(ks + st * BN * kLd, k + slab, j * BN, t);
  };
  auto issue_kv = [&](int j, int st) {
    issue_k(j, st);
    async_tile<T, HD, BN>(vs + st * BN * kLd, v + slab, j * BN, t);
  };
  async_tile<T, HD, kBM>(qs, q + slab, q0, t);
  issue_k(0, 0);
  cp_commit();

  // Pass 1: each thread's running max of its scores, reduced once.
  float m[2] = {ff::kNegInf, ff::kNegInf};
  for (int j = 0; j < nk; ++j) {
    const int st = ring_wait<S>(j, nk, issue_k);
    float s[BN / 8][4];
    scores<T, HD, BN>(s, qw, ks + st * BN * kLd, j * BN, rows, t, causal,
                      scale);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
    }
    ring_done<S>(j, nk, issue_k);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

  // Pass 2: p = exp(s - m) against the final max; no corrections.
  issue_kv(0, 0);
  cp_commit();
  float l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  zero<HD / 8>(acc);
  for (int j = 0; j < nk; ++j) {
    const int st = ring_wait<S>(j, nk, issue_kv);
    float s[BN / 8][4];
    scores<T, HD, BN>(s, qw, ks + st * BN * kLd, j * BN, rows, t, causal,
                      scale);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }
    warp_pv<BN, HD>(acc, s, vs + st * BN * kLd, kLd, wbuf);
    ring_done<S>(j, nk, issue_kv);
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_rows<T, HD>(o + slab, acc, q0 + warp * 16, t, 1.f / l[0], 1.f / l[1]);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int HD, int BN>
cudaError_t launch_variant(int variant, const void* q, const void* k,
                           const void* v, void* o, int bh, int t, int causal,
                           float scale, cudaStream_t stream) {
  using Kernel = void (*)(const T*, const T*, const T*, T*, int, int, float);
  const Kernel kernel = variant == 0   ? &row_state_kernel<T, HD, BN>
                        : variant == 1 ? &two_pass_kernel<T, HD, BN, true>
                                       : &two_pass_kernel<T, HD, BN, false>;
  const size_t smem = fwd_smem<T, HD, BN>(fwd_stages<T, HD, BN>());
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBM - 1) / kBM, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, t, hd) contiguous, 16-byte aligned, of one type (dtype:
// ff::kFloat32 or ff::kBFloat16).  variant: 0 row state (v2), 1 two passes
// (v3), 2 full row (v4).  hd in {64, 128}, block (the key tile) in {64,
// 128}, every t >= 1, 1 <= bh <= 65535.  Returns the launch's cudaError_t
// (0 = launched).
extern "C" int ff_flash_probe_fwd(int variant, const void* q, const void* k,
                                  const void* v, void* o, int bh, int t,
                                  int hd, int causal, float scale, int dtype,
                                  int block, void* stream) {
  if (variant < 0 || variant > 2 || bh < 1 || bh > 65535 || t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FF_PROBE_CALL(T, HD, BN)                                          \
  if (hd == HD && block == BN)                                            \
    return (int)launch_variant<T, HD, BN>(variant, q, k, v, o, bh, t,     \
                                          causal, scale, s);
#define FF_PROBE_TYPE(T)                                                  \
  FF_PROBE_CALL(T, 64, 64)                                                \
  FF_PROBE_CALL(T, 64, 128)                                               \
  FF_PROBE_CALL(T, 128, 64)                                               \
  FF_PROBE_CALL(T, 128, 128)
  if (dtype == ff::kFloat32) {
    FF_PROBE_TYPE(float)
  } else if (dtype == ff::kBFloat16) {
    FF_PROBE_TYPE(__nv_bfloat16)
  }
#undef FF_PROBE_TYPE
#undef FF_PROBE_CALL
  return (int)cudaErrorInvalidValue;
}
