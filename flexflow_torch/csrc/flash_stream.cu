// Streamed flash attention in f32, forward (K1s) and backward (K1sb), for
// Hopper (sm_90a).
//
// Replaces, for f32 operands, the TPU kernels
// flexflow_tpu/ops/pallas_kernels.py::_fwd_stream_kernel (launched by
// _fwd_stream_call) and ::_dq_stream_kernel / ::_dkv_stream_kernel
// (launched by _bwd_stream_call), the 3-D-grid forms that
// flash_attention_lse_streamed runs under FF_FLASH_STREAMED=1.  The function is the one flash_fwd.cu / flash_bwd.cu compute,
// with the same cast points: scores in f32 with the scale after the dot,
// the finite -1e30 mask, p rounded to the operand type before P.V (l
// summed from the f32 p), delta = rowsum(o * do) - g_lse, p recomputed
// from lse, ds = p (dp - delta) rounded to the operand type before its
// products, dq/dk scaled after the sum, every sum in f32 and written once
// in the input type.
//
// The bf16 streamed kernels are not here.  A bf16 K1s launches flash_fwd.cu's
// wgmma kernel (wg_fwd_kernel) and a bf16 K1sb flash_bwd.cu's wgmma pair
// (wg_dq_kernel, wg_dkv_kernel); kernels.fwd_entry / bwd_entry choose.  The
// TPU form's sequential third grid axis, which streams K/V (forward, dq
// pass) or Q/dO/lse/delta (dk/dv pass) through VMEM, is exactly the loop
// inside each of those kernels' CTAs over tiles that TMA feeds through an
// mbarrier ring, so the bf16 K1s gives K1f's bits and the bf16 K1sb K1b's.
// No key-range split: splitting a row's keys across CTAs needs a combine
// pass or float atomics, and at 32k b h = 8 already gives each kernel ~15
// waves on 132 SMs.  The f32 kernels stay here, on the FMA pipes: wgmma
// takes f32 only as TF32, which would round the operands to 10 mantissa
// bits and loosen the f32 checks the f32 parity step of chip_smoke.py
// relies on.
//
// What sets the streamed form apart, and its counterpart here:
//   * The TPU grid's sequential k axis (q axis for dk/dv) is a loop inside
//     the CTA, and the streamed tiles go through a two-stage cp.async ring
//     in shared memory (16-byte cp.async.cg copies, commit_group /
//     wait_group 1): tile j+1 is in flight while tile j is computed, as
//     Pallas double-buffers its pipelined BlockSpecs.  Rows past t are
//     zero-filled by the copy's source size, and masked.
//   * The products run on the FMA pipes in f32 with the fragment layout of
//     mma.m16n8k16 (mma_tile.cuh; PTX ISA, "Matrix Fragments for
//     mma.m16n8k16"), so each thread knows which rows and columns of the
//     score tile it holds: the running (m, l) and the rescale corr =
//     exp(m - m_new) stay in registers, and the P operand of P.V goes
//     through a warp-private shared tile.  Rows are padded by 16 bytes, so
//     the fragment reads are free of bank conflicts.
//
// Work split.  CTAs of 4 warps.  Forward and dq pass: one CTA per (bh,
// 64-row q tile), 16 query rows per warp, 64-key tiles streamed; the causal
// loop stops at the diagonal tile.  dk/dv pass: one CTA per (bh, 64-key
// tile), 16 key rows per warp, q/do/lse/delta tiles streamed from the
// diagonal tile on (32 rows at hd 128, to keep both f32 accumulators in
// registers; 64 below).  The dq pass computes delta for its rows, writes
// it, and the dk/dv pass, launched after it on the same stream, reads it.
// No atomics: two launches on the same inputs give the same bits.
//
// Bound.  At long t the kernels are bound by the operations (4 b h hd t^2/2
// FLOPs forward, 10 b h hd t^2/2 backward when causal) on the FMA pipes,
// 67 TFLOP/s in f32; f32 is the parity path, not the fast one.
#include "mma_tile.cuh"

namespace {

using namespace ff::tile;

// ---------------------------------------------------------------------------
// K1s: forward
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
stream_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int t, int causal, float scale) {
  using T = float;
  constexpr int kBN = 64;
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* ks = qs + kBM * kLd;                  // 2 stages x kBN x kLd
  T* vs = ks + 2 * kBN * kLd;              // 2 stages x kBN x kLd
  float* pbuf = reinterpret_cast<float*>(vs + 2 * kBN * kLd);

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  const size_t slab = (size_t)bh * t * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float* wbuf = pbuf + warp * 16 * (kBN + 4);

  const int kend = causal ? min(t, q0 + kBM) : t;
  const int nk = (kend + kBN - 1) / kBN;
  async_tile<T, HD, kBM>(qs, q + slab, q0, t);
  async_tile<T, HD, kBN>(ks, k + slab, 0, t);
  async_tile<T, HD, kBN>(vs, v + slab, 0, t);
  cp_commit();

  float m[2] = {ff::kNegInf, ff::kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
  zero<HD / 8>(acc);

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    if (j + 1 < nk) {  // tile j+1 into the other stage, then wait for tile j
      async_tile<T, HD, kBN>(ks + (st ^ 1) * kBN * kLd, k + slab, (j + 1) * kBN, t);
      async_tile<T, HD, kBN>(vs + (st ^ 1) * kBN * kLd, v + slab, (j + 1) * kBN, t);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + st * kBN * kLd;
    const T* vt = vs + st * kBN * kLd;

    float s[kBN / 8][4];
    zero<kBN / 8>(s);
    warp_abt<HD, kBN>(s, qs + warp * 16 * kLd, kLd, kt, kLd);

    const int k0 = j * kBN;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * tq + (e & 1);
        const bool masked = col >= t || (causal && col > rows[e >> 1]);
        s[nt][e] = masked ? ff::kNegInf : s[nt][e] * scale;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = expf(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];  // lane partials
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
    warp_pv<kBN, HD>(acc, s, vt, kLd, wbuf);
    __syncthreads();  // every warp is done with stage st before it refills
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  store_rows<T, HD>(o + slab, acc, q0 + warp * 16, t, 1.f / l[0], 1.f / l[1]);
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rows[h] < t) lse[(size_t)bh * t + rows[h]] = m[h] + logf(l[h]);
  }
}

// ---------------------------------------------------------------------------
// K1sb, pass 1: delta and dq
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
stream_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ g_lse, float* __restrict__ delta,
                 float* __restrict__ dq, int t, int causal, float scale) {
  using T = float;
  constexpr int kBN = 64;
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* dos = qs + kBM * kLd;                 // kBM x kLd
  T* ks = dos + kBM * kLd;                 // 2 stages x kBN x kLd
  T* vs = ks + 2 * kBN * kLd;              // 2 stages x kBN x kLd
  float* lse_s = reinterpret_cast<float*>(vs + 2 * kBN * kLd);  // kBM
  float* delta_s = lse_s + kBM;                                  // kBM
  float* pbuf = delta_s + kBM;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const size_t slab = (size_t)bh * t * HD;
  const size_t row_base = (size_t)bh * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows in the tile
  float* wbuf = pbuf + warp * 16 * (kBN + 4);

  const int kend = causal ? min(t, q0 + kBM) : t;
  const int nk = (kend + kBN - 1) / kBN;
  async_tile<T, HD, kBM>(qs, q + slab, q0, t);
  async_tile<T, HD, kBM>(dos, dout + slab, q0, t);
  async_rows<kBM>(lse_s, lse + row_base, q0, t);
  cp_commit();
  async_tile<T, HD, kBN>(ks, k + slab, 0, t);
  async_tile<T, HD, kBN>(vs, v + slab, 0, t);
  cp_commit();
  cp_wait<1>();  // q, do, lse have landed; the first k/v tile may not have
  __syncthreads();

  // delta for the tile's rows: two lanes per row, o read from global memory.
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < t) {
      const T* orow = o + slab + (size_t)qp * HD;
      const T* drow = dos + r * kLd;
#pragma unroll 8
      for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d)
        acc = fmaf(ff::to_float(orow[d]), ff::to_float(drow[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      float dl = 0.f;
      if (qp < t) {
        dl = acc - (g_lse != nullptr ? g_lse[row_base + qp] : 0.f);
        delta[row_base + qp] = dl;
      }
      delta_s[r] = dl;
    }
  }

  float acc[HD / 8][4];
  zero<HD / 8>(acc);
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    if (j + 1 < nk) {
      async_tile<T, HD, kBN>(ks + (st ^ 1) * kBN * kLd, k + slab, (j + 1) * kBN, t);
      async_tile<T, HD, kBN>(vs + (st ^ 1) * kBN * kLd, v + slab, (j + 1) * kBN, t);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // also publishes delta_s on the first pass
    const T* kt = ks + st * kBN * kLd;
    const T* vt = vs + st * kBN * kLd;

    float s[kBN / 8][4], dp[kBN / 8][4];
    zero<kBN / 8>(s);
    zero<kBN / 8>(dp);
    warp_abt<HD, kBN>(s, qs + warp * 16 * kLd, kLd, kt, kLd);
    warp_abt<HD, kBN>(dp, dos + warp * 16 * kLd, kLd, vt, kLd);
    const int k0 = j * kBN;
    const float ls[2] = {lse_s[lr[0]], lse_s[lr[1]]};
    const float dl[2] = {delta_s[lr[0]], delta_s[lr[1]]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * tq + (e & 1);
        const int h = e >> 1;
        const bool masked = col >= t || (causal && col > q0 + lr[h]);
        const float p = masked ? 0.f : expf(s[nt][e] * scale - ls[h]);
        s[nt][e] = p * (dp[nt][e] - dl[h]);  // ds, rounded in warp_pv
      }
    }
    warp_pv<kBN, HD>(acc, s, kt, kLd, wbuf);
    __syncthreads();
  }
  store_rows<T, HD>(dq + slab, acc, q0 + warp * 16, t, scale, scale);
}

// ---------------------------------------------------------------------------
// K1sb, pass 2: dk and dv
// ---------------------------------------------------------------------------

template <int HD, int BN>
__global__ void __launch_bounds__(kThreads)
stream_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int t, int causal, float scale) {
  using T = float;
  constexpr int kLd = pitch<T>(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // kBM x kLd
  T* vs = ks + kBM * kLd;                  // kBM x kLd
  T* qs = vs + kBM * kLd;                  // 2 stages x BN x kLd
  T* dos = qs + 2 * BN * kLd;              // 2 stages x BN x kLd
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BN * kLd);  // 2 x BN
  float* delta_s = lse_s + 2 * BN;                               // 2 x BN
  float* pbuf = delta_s + 2 * BN;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBM;
  const size_t slab = (size_t)bh * t * HD;
  const size_t row_base = (size_t)bh * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float* wbuf = pbuf + warp * 16 * (BN + 4);

  // Query tiles that see this key tile: all, or from the diagonal on.
  const int i0 = causal ? k0 / BN : 0;
  const int ni = (t + BN - 1) / BN;
  auto issue = [&](int i, int st) {
    async_tile<T, HD, BN>(qs + st * BN * kLd, q + slab, i * BN, t);
    async_tile<T, HD, BN>(dos + st * BN * kLd, dout + slab, i * BN, t);
    async_rows<BN>(lse_s + st * BN, lse + row_base, i * BN, t);
    async_rows<BN>(delta_s + st * BN, delta + row_base, i * BN, t);
  };
  async_tile<T, HD, kBM>(ks, k + slab, k0, t);
  async_tile<T, HD, kBM>(vs, v + slab, k0, t);
  issue(i0, 0);
  cp_commit();

  float adk[HD / 8][4], adv[HD / 8][4];
  zero<HD / 8>(adk);
  zero<HD / 8>(adv);
  for (int i = i0; i < ni; ++i) {
    const int st = (i - i0) & 1;
    if (i + 1 < ni) {
      issue(i + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* qt = qs + st * BN * kLd;
    const T* dot = dos + st * BN * kLd;
    const float* ls = lse_s + st * BN;
    const float* dls = delta_s + st * BN;

    // s^T = k q^T: rows are this warp's keys, columns the tile's queries.
    float p[BN / 8][4];
    zero<BN / 8>(p);
    warp_abt<HD, BN>(p, ks + warp * 16 * kLd, kLd, qt, kLd);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tq + (e & 1);
        const int qp = i * BN + c;
        const int kp = keys[e >> 1];
        const bool masked = qp >= t || kp >= t || (causal && kp > qp);
        p[nt][e] = masked ? 0.f : expf(p[nt][e] * scale - ls[c]);
      }
    }
    warp_pv<BN, HD>(adv, p, dot, kLd, wbuf);  // dv += p^T do (p rounded)
    float dpt[BN / 8][4];
    zero<BN / 8>(dpt);
    warp_abt<HD, BN>(dpt, vs + warp * 16 * kLd, kLd, dot, kLd);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * tq + (e & 1);
        p[nt][e] = p[nt][e] * (dpt[nt][e] - dls[c]);  // ds^T
      }
    }
    warp_pv<BN, HD>(adk, p, qt, kLd, wbuf);  // dk += ds^T q (ds rounded)
    __syncthreads();
  }
  store_rows<T, HD>(dk + slab, adk, k0 + warp * 16, t, scale, scale);
  store_rows<T, HD>(dv + slab, adv, k0 + warp * 16, t, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr int dkv_bn() { return HD >= 128 ? 32 : 64; }

template <int HD>
size_t fwd_smem() {
  return sizeof(float) * ((size_t)(kBM + 4 * 64) * pitch<float>(HD) +
                          pbuf_floats(64));
}

template <int HD>
size_t dq_smem() {
  return sizeof(float) * ((size_t)(2 * kBM + 4 * 64) * pitch<float>(HD) +
                          2 * kBM + pbuf_floats(64));
}

template <int HD>
size_t dkv_smem() {
  constexpr int bn = dkv_bn<HD>();
  return sizeof(float) * ((size_t)(2 * kBM + 4 * bn) * pitch<float>(HD) +
                          4 * bn + pbuf_floats(bn));
}

// Above 48 KB dynamic shared memory needs an opt-in per kernel.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int t, int causal, float scale,
                       cudaStream_t stream) {
  using T = float;
  const size_t smem = fwd_smem<HD>();
  cudaError_t err = allow_smem(stream_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBM - 1) / kBM, bh);
  stream_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, t, causal, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       const float* g_lse, float* delta, void* dq, void* dk,
                       void* dv, int bh, int t, int causal, float scale,
                       cudaStream_t stream) {
  using T = float;
  constexpr int bn = dkv_bn<HD>();
  const size_t smem_dq = dq_smem<HD>(), smem_dkv = dkv_smem<HD>();
  cudaError_t err = allow_smem(stream_dq_kernel<HD>, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(stream_dkv_kernel<HD, bn>, smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kBM - 1) / kBM, bh);
  stream_dq_kernel<HD><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, g_lse, delta, static_cast<T*>(dq), t,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stream_dkv_kernel<HD, bn><<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), t, causal, scale);
  return cudaGetLastError();
}

bool shape_ok(int bh, int t, int hd) {
  return bh >= 1 && bh <= 65535 && t >= 1 &&
         (hd == 32 || hd == 64 || hd == 128);
}

// Register, spill and shared-memory use of one kernel (which: 0 forward,
// 1 dq pass, 2 dk/dv pass; all f32).
template <int HD>
cudaError_t attrs(int which, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  size_t dyn;
  if (which == 0) {
    err = cudaFuncGetAttributes(&a, stream_fwd_kernel<HD>);
    dyn = fwd_smem<HD>();
  } else if (which == 1) {
    err = cudaFuncGetAttributes(&a, stream_dq_kernel<HD>);
    dyn = dq_smem<HD>();
  } else {
    err = cudaFuncGetAttributes(&a, stream_dkv_kernel<HD, dkv_bn<HD>()>);
    dyn = dkv_smem<HD>();
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)dyn;
  return err;
}

}  // namespace

#define FF_STREAM_HD(CALL)                                              \
  if (hd == 32) { constexpr int HD = 32; return (int)CALL; }            \
  if (hd == 64) { constexpr int HD = 64; return (int)CALL; }            \
  if (hd == 128) { constexpr int HD = 128; return (int)CALL; }

// q, k, v, o: (bh, t, hd) contiguous, 16-byte aligned, f32 (dtype must be
// ff::kFloat32: the bf16 K1s is flash_fwd.cu's ff_flash_fwd); lse: (bh, t)
// f32.  hd in {32, 64, 128}, every t >= 1.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int ff_flash_stream_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int t, int hd, int causal, float scale,
                                   int dtype, void* stream) {
  if (!shape_ok(bh, t, hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype != ff::kFloat32) return (int)cudaErrorInvalidValue;
  FF_STREAM_HD((launch_fwd<HD>(q, k, v, o, lse_f, bh, t, causal, scale, s)));
  return (int)cudaErrorInvalidValue;
}

// The forward's operands plus o and dout (bh, t, hd), all f32 (dtype must
// be ff::kFloat32: the bf16 K1sb is flash_bwd.cu's ff_flash_bwd); lse,
// delta: (bh, t) f32; g_lse: (bh, t) f32 or null (no lse cotangent).
// delta is scratch that the first pass writes and the second reads.
// Launches both passes on the stream; returns the first cudaError_t (0 =
// both launched).
extern "C" int ff_flash_stream_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   const void* g_lse, void* delta, void* dq,
                                   void* dk, void* dv, int bh, int t, int hd,
                                   int causal, float scale, int dtype,
                                   void* stream) {
  if (!shape_ok(bh, t, hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* g_f = static_cast<const float*>(g_lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype != ff::kFloat32) return (int)cudaErrorInvalidValue;
  FF_STREAM_HD((launch_bwd<HD>(q, k, v, o, dout, lse_f, g_f, delta_f, dq, dk,
                               dv, bh, t, causal, scale, s)));
  return (int)cudaErrorInvalidValue;
}

// out[0..2] = registers per thread, local (spill) bytes per thread and the
// dynamic shared memory of kernel `which` (0 forward, 1 dq, 2 dk/dv) at head
// dim hd; dtype must be ff::kFloat32 (the kernels are f32 only).
extern "C" int ff_flash_stream_attrs(int which, int hd, int dtype, int* out) {
  if (which < 0 || which > 2 || dtype != ff::kFloat32)
    return (int)cudaErrorInvalidValue;
  FF_STREAM_HD((attrs<HD>(which, out)));
  return (int)cudaErrorInvalidValue;
}
