// Flash-backward variant of the kernel race (P2) for Hopper (sm_90a): the
// row-state backward, dq, dk and dv of causal or non-causal attention over
// (bh, t, hd) slabs from q, k, v, do and the caller's lse and delta; the
// f32 instantiation.  The bf16 b2 is K1b's wgmma pair (flash_bwd.cu,
// ff_flash_bwd_row_state), whose dq pass then reads the caller's delta.
//
// Replaces the TPU kernels of tools/probe_flash_bwd_variants.py (launched
// by _bwd_call_lanes, :155): _dq_kernel_lanes (:37) and _dkv_kernel_lanes
// (:91).  Their remedy was to widen lse and delta once to 128 lanes and
// tile them per block, instead of broadcasting a width-1 column per pair.
// The Hopper counterpart of that row state: each thread loads the lse and
// delta of the rows it owns in the m16n8k16 fragment layout into registers
// once (the dq pass: its two query rows, once per CTA; the dk/dv pass: the
// query rows its score columns hold, once per query sub-tile) and applies
// them to its score registers with no shared-memory or shuffle broadcast.
// Unlike K1b and K1sb it takes delta = rowsum(o do) - g_lse from the caller
// and reads neither o nor g_lse.  (The TPU's (bh, t, 8) lane copies of lse
// and delta are a TPU artefact: both are (bh, t) f32 here.)
//
// Function and cast points, as K1b: p = exp(s - lse) from f32 scores with
// the scale after the dot and the finite -1e30 mask, ds = p (do v^T -
// delta), dv = p^T do, dq = scale ds k and dk = scale ds^T q; f32 sums
// written once.
//
// Work split.  Two passes on the stream, as on the TPU, with no atomics, so
// two launches give the same bits.  dq pass: one CTA of 4 warps per (bh,
// 64-row q tile), 16 query rows per warp, key tiles of BN (the race's block,
// 64 or 128) through the cp.async ring of mma_tile.cuh; the causal loop
// stops at the diagonal.  dk/dv pass: one CTA per (bh, 64-key tile), query
// tiles of BN from the diagonal on.  A staged tile is consumed in register
// sub-tiles (64 columns; 32 in the dk/dv pass at hd 128, where two f32
// accumulators already hold 128 registers), so BN sets the staging and not
// the register footprint.  The ring has two stages where they fit in 227 KB
// of shared memory, one otherwise (hd 128 and BN 128).  The products run on
// the FMA pipes, no TF32 (wgmma takes f32 only as TF32).
//
// Bound.  The five t x t x hd products, 10 b h hd t^2 / 2 FLOPs when
// causal, at the FMA pipes' 67 TFLOP/s in f32.
#include "mma_tile.cuh"

namespace {

using namespace ff::tile;

// Register sub-tile widths of the two passes.
constexpr int kSubDq = 64;
template <int HD>
__host__ __device__ constexpr int sub_dkv() { return HD >= 128 ? 32 : 64; }

// Shared bytes of either pass: two resident 64-row tiles, two streamed
// tiles per stage, and the P tile per warp.
template <int HD, int BN>
__host__ __device__ constexpr size_t bwd_smem(int stages, int sub) {
  return sizeof(float) *
         ((size_t)(2 * kBM + 2 * stages * BN) * pitch<float>(HD) +
          pbuf_floats(sub));
}

template <int HD, int BN>
__host__ __device__ constexpr int bwd_stages(int sub) {
  return bwd_smem<HD, BN>(2, sub) <= kSmemMax ? 2 : 1;
}

// ---------------------------------------------------------------------------
// pass 1: dq
// ---------------------------------------------------------------------------

template <int HD, int BN>
__global__ void __launch_bounds__(kThreads)
row_state_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int t, int causal, float scale) {
  using T = float;
  constexpr int S = bwd_stages<HD, BN>(kSubDq);
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* dos = qs + kBM * kLd;                 // kBM x kLd
  T* ks = dos + kBM * kLd;                 // S stages x BN x kLd
  T* vs = ks + S * BN * kLd;               // S stages x BN x kLd
  float* pbuf = reinterpret_cast<float*>(vs + S * BN * kLd);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  const size_t slab = (size_t)blockIdx.y * t * HD;
  const size_t row_base = (size_t)blockIdx.y * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float* wbuf = pbuf + warp * 16 * (kSubDq + 4);
  const int kend = causal ? min(t, q0 + kBM) : t;
  const int nk = (kend + BN - 1) / BN;
  auto issue = [&](int j, int st) {
    async_tile<T, HD, BN>(ks + st * BN * kLd, k + slab, j * BN, t);
    async_tile<T, HD, BN>(vs + st * BN * kLd, v + slab, j * BN, t);
  };
  async_tile<T, HD, kBM>(qs, q + slab, q0, t);
  async_tile<T, HD, kBM>(dos, dout + slab, q0, t);
  issue(0, 0);
  cp_commit();

  // The row state of this thread's two rows, loaded once.
  float ls[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < t;
    ls[h] = ok ? lse[row_base + rows[h]] : 0.f;
    dl[h] = ok ? delta[row_base + rows[h]] : 0.f;
  }

  float acc[HD / 8][4];
  zero<HD / 8>(acc);
  for (int j = 0; j < nk; ++j) {
    const int st = ring_wait<S>(j, nk, issue);
    const T* kt = ks + st * BN * kLd;
    const T* vt = vs + st * BN * kLd;
    for (int c0 = 0; c0 < BN && j * BN + c0 < kend; c0 += kSubDq) {
      float s[kSubDq / 8][4], dp[kSubDq / 8][4];
      zero<kSubDq / 8>(s);
      zero<kSubDq / 8>(dp);
      warp_abt<HD, kSubDq>(s, qs + warp * 16 * kLd, kLd, kt + c0 * kLd, kLd);
      warp_abt<HD, kSubDq>(dp, dos + warp * 16 * kLd, kLd, vt + c0 * kLd,
                           kLd);
#pragma unroll
      for (int nt = 0; nt < kSubDq / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * BN + c0 + nt * 8 + 2 * tq + (e & 1);
          const int h = e >> 1;
          const bool masked = col >= t || (causal && col > rows[h]);
          const float p = masked ? 0.f : expf(s[nt][e] * scale - ls[h]);
          s[nt][e] = p * (dp[nt][e] - dl[h]);  // ds
        }
      }
      warp_pv<kSubDq, HD>(acc, s, kt + c0 * kLd, kLd, wbuf);
    }
    ring_done<S>(j, nk, issue);
  }
  store_rows<T, HD>(dq + slab, acc, q0 + warp * 16, t, scale, scale);
}

// ---------------------------------------------------------------------------
// pass 2: dk and dv
// ---------------------------------------------------------------------------

template <int HD, int BN>
__global__ void __launch_bounds__(kThreads)
row_state_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int t, int causal, float scale) {
  using T = float;
  constexpr int kSub = sub_dkv<HD>();
  constexpr int S = bwd_stages<HD, BN>(kSub);
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* vs = ks + kBM * kLd;                  // kBM x kLd
  T* qs = vs + kBM * kLd;                  // S stages x BN x kLd
  T* dos = qs + S * BN * kLd;              // S stages x BN x kLd
  float* pbuf = reinterpret_cast<float*>(dos + S * BN * kLd);

  const int k0 = blockIdx.x * kBM;
  const size_t slab = (size_t)blockIdx.y * t * HD;
  const size_t row_base = (size_t)blockIdx.y * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float* wbuf = pbuf + warp * 16 * (kSub + 4);

  // Query tiles that see this key tile: all, or from the diagonal on.
  const int i0 = causal ? k0 / BN : 0;
  const int n = (t + BN - 1) / BN - i0;
  auto issue = [&](int j, int st) {
    async_tile<T, HD, BN>(qs + st * BN * kLd, q + slab, (i0 + j) * BN, t);
    async_tile<T, HD, BN>(dos + st * BN * kLd, dout + slab, (i0 + j) * BN, t);
  };
  async_tile<T, HD, kBM>(ks, k + slab, k0, t);
  async_tile<T, HD, kBM>(vs, v + slab, k0, t);
  issue(0, 0);
  cp_commit();

  float adk[HD / 8][4], adv[HD / 8][4];
  zero<HD / 8>(adk);
  zero<HD / 8>(adv);
  for (int j = 0; j < n; ++j) {
    const int st = ring_wait<S>(j, n, issue);
    const T* qt = qs + st * BN * kLd;
    const T* dot = dos + st * BN * kLd;
    for (int c0 = 0; c0 < BN; c0 += kSub) {
      const int r0 = (i0 + j) * BN + c0;  // the sub-tile's first query row
      if (r0 >= t) break;
      if (causal && r0 + kSub <= k0) continue;  // every pair masked
      // The row state of the query rows this thread's columns hold.
      float lc[kSub / 8][2], dc[kSub / 8][2];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int r = r0 + nt * 8 + 2 * tq + b;
          lc[nt][b] = r < t ? lse[row_base + r] : 0.f;
          dc[nt][b] = r < t ? delta[row_base + r] : 0.f;
        }
      }
      // s^T = k q^T: rows are this warp's keys, columns the sub-tile's
      // queries.
      float p[kSub / 8][4];
      zero<kSub / 8>(p);
      warp_abt<HD, kSub>(p, ks + warp * 16 * kLd, kLd, qt + c0 * kLd, kLd);
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r0 + nt * 8 + 2 * tq + (e & 1);
          const int kp = keys[e >> 1];
          const bool masked = qp >= t || kp >= t || (causal && kp > qp);
          p[nt][e] = masked ? 0.f : expf(p[nt][e] * scale - lc[nt][e & 1]);
        }
      }
      warp_pv<kSub, HD>(adv, p, dot + c0 * kLd, kLd, wbuf);
      float dpt[kSub / 8][4];
      zero<kSub / 8>(dpt);
      warp_abt<HD, kSub>(dpt, vs + warp * 16 * kLd, kLd, dot + c0 * kLd, kLd);
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = p[nt][e] * (dpt[nt][e] - dc[nt][e & 1]);  // ds^T
      }
      warp_pv<kSub, HD>(adk, p, qt + c0 * kLd, kLd, wbuf);
    }
    ring_done<S>(j, n, issue);
  }
  store_rows<T, HD>(dk + slab, adk, k0 + warp * 16, t, scale, scale);
  store_rows<T, HD>(dv + slab, adv, k0 + warp * 16, t, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, int BN>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dq, void* dk, void* dv, int bh, int t,
                       int causal, float scale, cudaStream_t stream) {
  using T = float;
  constexpr int kSub = sub_dkv<HD>();
  const size_t smem_dq = bwd_smem<HD, BN>(bwd_stages<HD, BN>(kSubDq),
                                          kSubDq);
  const size_t smem_dkv = bwd_smem<HD, BN>(bwd_stages<HD, BN>(kSub), kSub);
  cudaError_t err = cudaFuncSetAttribute(
      row_state_dq_kernel<HD, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(row_state_dkv_kernel<HD, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBM - 1) / kBM, bh);
  row_state_dq_kernel<HD, BN><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), t, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_state_dkv_kernel<HD, BN><<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), t, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (bh, t, hd) f32 contiguous, 16-byte aligned
// (dtype must be ff::kFloat32); lse, delta: (bh, t) f32.  hd in {64, 128},
// block (the streamed tile) in {64, 128}, every t >= 1, 1 <= bh <= 65535.
// Launches both passes on the stream; returns the first cudaError_t (0 =
// both launched).
extern "C" int ff_flash_probe_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk,
                                  void* dv, int bh, int t, int hd, int causal,
                                  float scale, int dtype, int block,
                                  void* stream) {
  if (dtype != ff::kFloat32 || bh < 1 || bh > 65535 || t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
#define FF_PROBE_CALL(HD, BN)                                               \
  if (hd == HD && block == BN)                                              \
    return (int)launch_bwd<HD, BN>(q, k, v, dout, lse_f, delta_f, dq, dk,   \
                                   dv, bh, t, causal, scale, s);
  FF_PROBE_CALL(64, 64)
  FF_PROBE_CALL(64, 128)
  FF_PROBE_CALL(128, 64)
  FF_PROBE_CALL(128, 128)
#undef FF_PROBE_CALL
  return (int)cudaErrorInvalidValue;
}
